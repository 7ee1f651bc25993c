"""The benchmark's one adapter to the program's configuration type."""

from __future__ import annotations


def model_config(mc: dict):
    """``repro_torch``'s ``ModelConfig`` of a dense decoder configuration
    file (``configs/<name>.json``)."""
    from repro_torch.configs.base import ModelConfig, dense_stack

    return ModelConfig(
        name=mc["name"], arch_type="dense", citation=mc["source"],
        d_model=mc["d_model"], n_layers=mc["n_layers"],
        n_heads=mc["n_heads"], n_kv_heads=mc["n_kv_heads"],
        head_dim=mc["head_dim"], d_ff=mc["d_ff"],
        vocab_size=mc["vocab_size"], stack=dense_stack(mc["n_layers"]),
        ffn_kind=mc["ffn_kind"], norm=mc["norm"],
        rope_theta=mc["rope_theta"], tie_embeddings=mc["tie_embeddings"],
        param_dtype=mc["param_dtype"], compute_dtype=mc["compute_dtype"],
        use_flash=mc.get("use_flash", False))

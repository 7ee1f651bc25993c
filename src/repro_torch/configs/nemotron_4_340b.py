"""Nemotron-4-340B — dense GQA, squared-ReLU FFN [arXiv:2402.16819].

The same numbers as ``repro.configs.nemotron_4_340b``: d_model 18432, 96
layers, 96 query heads over 8 KV heads (group 12) of 192, d_ff 73728
(squared ReLU), vocab 256000, untied head, bf16 — 341,022,081,024
parameters; at 2 layers (the depth one card takes) 16.3 B.
"""

from repro_torch.configs.base import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        arch_type="dense",
        citation="arXiv:2402.16819",
        d_model=18432,
        n_layers=96,
        n_heads=96,
        n_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        stack=dense_stack(96),
        ffn_kind="relu2",
        norm="rmsnorm",
        tie_embeddings=False,
        rope_theta=10000.0,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=1,
        optimizer="adafactor",     # factored states: fits the pod (DESIGN.md)
        lr=1e-4,
        remat=True,
        long_context_mode="window",
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=256, n_layers=2, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, stack=dense_stack(2), remat=False,
        param_dtype="float32", compute_dtype="float32",
    )

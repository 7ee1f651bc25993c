"""Gemma-7B — dense, GeGLU, head_dim 256 [arXiv:2403.08295].

The same numbers as ``repro.configs.gemma_7b``: d_model 3072, 28 layers,
16 heads of 256 (no grouping), d_ff 24576 (GeGLU), vocab 256000, tied
embeddings, bf16 — 8,537,505,792 parameters, 17.08 GB in bf16.
"""

from repro_torch.configs.base import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        arch_type="dense",
        citation="arXiv:2403.08295",
        d_model=3072,
        n_layers=28,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        stack=dense_stack(28),
        ffn_kind="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=16,
        remat=True,
        optimizer="adafactor",
        lr=1e-4,
        long_context_mode="window",
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=512, stack=dense_stack(2),
        param_dtype="float32", compute_dtype="float32",
    )

"""OLMo-1B — dense, non-parametric LayerNorm [arXiv:2402.00838].

The same numbers as ``repro.configs.olmo_1b``: d_model 2048, 16 layers,
16 heads of 128 (no grouping), d_ff 8192 (SwiGLU), vocab 50304,
``ln_nonparam`` norms (no norm parameters), tied embeddings, bf16 —
1,176,764,416 parameters, 2.35 GB in bf16.
"""

from repro_torch.configs.base import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        arch_type="dense",
        citation="arXiv:2402.00838",
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        stack=dense_stack(16),
        ffn_kind="swiglu",
        norm="ln_nonparam",          # OLMo's non-parametric LN
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=16,
        remat=True,
        optimizer="adamw",
        lr=3e-4,
        long_context_mode="window",
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, stack=dense_stack(2),
        param_dtype="float32", compute_dtype="float32",
    )

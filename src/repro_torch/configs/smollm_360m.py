"""SmolLM-360M — llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM-135M].

The same numbers as ``repro.configs.smollm_360m``: d_model 960, 32 layers,
15 query heads over 5 KV heads (group 3), head_dim 64, d_ff 2560, vocab
49152, tied embeddings, bf16 — 361,758,720 parameters, 723.5 MB in bf16.
"""

from repro_torch.configs.base import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        arch_type="dense",
        citation="hf:HuggingFaceTB/SmolLM-135M",
        d_model=960,
        n_layers=32,
        n_heads=15,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        stack=dense_stack(32),
        ffn_kind="swiglu",
        norm="rmsnorm",
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
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, stack=dense_stack(2),
        param_dtype="float32", compute_dtype="float32",
    )

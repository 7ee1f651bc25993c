"""Qwen3-30B-A3B — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

The same numbers as ``repro.configs.qwen3_moe_30b_a3b``: d_model 2048, 48
layers, each attention (32 query heads over 4 KV heads of 128, group 8)
and a 128-expert top-8 MoE of expert width 768, vocab 151936, untied head,
bf16 — 30,531,911,680 parameters (3,352,821,760 active per token), 61.06 GB
in bf16, which one 80 GB card holds whole.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        citation="hf:Qwen/Qwen3-30B-A3B",
        d_model=2048,
        n_layers=48,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,                     # (per-expert hidden; all-MoE stack)
        vocab_size=151936,
        stack=((48, (LayerSpec("attn", "moe"),)),),
        ffn_kind="swiglu",
        norm="rmsnorm",
        tie_embeddings=False,
        n_experts=128,
        moe_top_k=8,
        n_shared_experts=0,
        expert_d_ff=768,
        capacity_factor=1.25,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=1,
        remat=True,
        optimizer="adafactor",
        lr=1e-4,
        long_context_mode="window",
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, expert_d_ff=64, vocab_size=512, n_experts=4, moe_top_k=2,
        stack=((2, (LayerSpec("attn", "moe"),)),),
        param_dtype="float32", compute_dtype="float32",
    )

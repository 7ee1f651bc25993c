"""Jamba-v0.1-52B — Mamba + attention 1:7 interleave, MoE 16 experts top-2
[arXiv:2403.19887].

The same numbers as ``repro.configs.jamba_v0_1_52b``: d_model 4096, 4
blocks of 8 layers, each block Mamba-1 mixers (d_state 16, conv 4, expand
2, dt rank 256) with attention at index 3 (32 query heads over 8 KV heads
of 128, group 4) and a 16-expert top-2 MoE of width 14336 at every odd
index, dense SwiGLU FFNs of 14336 at the even ones, vocab 65536, untied
head, bf16 — 51,569,819,648 parameters (12,109,807,616 active per
token), 103.14 GB in bf16, more than one 80 GB card holds; 2 of the 4
blocks (26,053,345,280 parameters, 52.11 GB) do fit.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def _pattern() -> tuple:
    # One 8-layer Jamba block: attention at index 3, MoE every other layer.
    return tuple(
        LayerSpec(
            mixer="attn" if j == 3 else "mamba",
            ffn="moe" if j % 2 == 1 else "dense",
        )
        for j in range(8)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        arch_type="hybrid",
        citation="arXiv:2403.19887",
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        stack=((4, _pattern()),),
        ffn_kind="swiglu",
        norm="rmsnorm",
        tie_embeddings=False,
        n_experts=16,
        moe_top_k=2,
        expert_d_ff=14336,
        capacity_factor=1.25,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        mamba_dt_rank=256,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=1,
        remat=True,
        optimizer="adafactor",
        lr=1e-4,
        long_context_mode="native",   # hybrid: Mamba state + few attn layers
        long_context_window=8192,     # the 1:8 attn layers window at 500k
        sliding_window=None,
    )


def smoke_config() -> ModelConfig:
    pattern = (
        LayerSpec("mamba", "dense"),
        LayerSpec("attn", "moe"),
    )
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, expert_d_ff=256, vocab_size=512, n_experts=4, moe_top_k=2,
        stack=((1, pattern),), mamba_dt_rank=8,
        param_dtype="float32", compute_dtype="float32",
    )

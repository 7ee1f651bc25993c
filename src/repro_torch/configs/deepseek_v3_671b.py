"""DeepSeek-V3-671B — MLA, 1 shared + 256 routed experts top-8 [arXiv:2412.19437].

The same numbers as ``repro.configs.deepseek_v3_671b``: d_model 7168, 61
layers of MLA (128 heads; q rank 1536, KV latent rank 512, no-rope and
value dims 128, a shared 64-dim rope key), the first 3 with a dense SwiGLU
FFN of 18432, the other 58 with a 256-expert top-8 MoE of expert width
2048 and one shared expert; vocab 129280, untied head, bf16 —
671,025,397,760 parameters, more than one 80 GB card holds.  The absorbed
decode caches 512 + 64 = 576 values a token and layer.  Multi-token
prediction is opt-in (``replace(mtp_depth=1)``).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        arch_type="moe",
        citation="arXiv:2412.19437",
        d_model=7168,
        n_layers=61,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,                   # dense-layer FFN width
        vocab_size=129280,
        stack=(
            (3, (LayerSpec("mla", "dense"),)),
            (58, (LayerSpec("mla", "moe"),)),
        ),
        ffn_kind="swiglu",
        norm="rmsnorm",
        tie_embeddings=False,
        n_experts=256,
        moe_top_k=8,
        n_shared_experts=1,
        expert_d_ff=2048,
        capacity_factor=1.25,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=1,
        optimizer="adafactor",
        lr=1e-4,
        remat=True,
        long_context_mode="native",   # MLA compressed cache
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, expert_d_ff=64, vocab_size=512,
        n_experts=4, moe_top_k=2, n_shared_experts=1,
        q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        stack=(
            (1, (LayerSpec("mla", "dense"),)),
            (1, (LayerSpec("mla", "moe"),)),
        ),
        remat=False,
        param_dtype="float32", compute_dtype="float32",
    )

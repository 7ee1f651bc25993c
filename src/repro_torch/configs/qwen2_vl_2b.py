"""Qwen2-VL-2B — VLM backbone with M-RoPE, dynamic resolution [arXiv:2409.12191].

The same numbers as ``repro.configs.qwen2_vl_2b``: d_model 1536, 28
layers, 12 query heads over 2 KV heads (group 6) of 128, d_ff 8960, vocab
151936, M-RoPE with (16, 24, 24) frequency pairs for (t, h, w), tied
embeddings, bf16 — 1,543,569,408 parameters, 3.09 GB in bf16.  The
vision tower is a stub, as in the reference: a batch may carry
pre-projected patch embeddings ``vision_embeds`` [B, S_v, d_model] that
prefix the text.
"""

from repro_torch.configs.base import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        citation="arXiv:2409.12191",
        d_model=1536,
        n_layers=28,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        stack=dense_stack(28),
        ffn_kind="swiglu",
        norm="rmsnorm",
        rope_type="mrope",
        mrope_sections=(16, 24, 24),   # freq pairs per (t, h, w); sum = 64
        rope_theta=1000000.0,
        tie_embeddings=True,
        vision_prefix_frac=0.25,       # quarter of the sequence is patches
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=16,
        remat=True,
        optimizer="adamw",
        lr=1e-4,
        long_context_mode="window",
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, stack=dense_stack(2),
        mrope_sections=(4, 6, 6),
        param_dtype="float32", compute_dtype="float32",
    )

"""RWKV6-3B ("Finch") — attention-free, data-dependent decay [arXiv:2404.05892].

The same numbers as ``repro.configs.rwkv6_3b``: d_model 2560, 32 layers,
each an RWKV6 time mix (40 heads of 64, a decay LoRA of rank 64) and a
squared-ReLU channel mix of width 8960, vocab 65536, untied head, bf16 —
2,862,776,320 parameters, 5.73 GB in bf16, which one card holds whole.  Its
decode state is O(1) in the sequence: per layer and row a 40 x 64 x 64
float32 WKV state and the previous token's [D] activation.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        arch_type="ssm",
        citation="arXiv:2404.05892",
        d_model=2560,
        n_layers=32,
        n_heads=40,                  # d_model / rwkv_head_size
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65536,
        stack=((32, (LayerSpec("rwkv6", "dense"),)),),
        ffn_kind="relu2",            # RWKV channel-mix uses squared ReLU
        norm="rmsnorm",
        rope_type="none",
        tie_embeddings=False,
        rwkv_head_size=64,
        rwkv_decay_lora=64,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=16,
        remat=True,
        optimizer="adamw",
        lr=3e-4,
        long_context_mode="native",  # O(1) recurrent state
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        stack=((2, (LayerSpec("rwkv6", "dense"),)),),
        rwkv_head_size=32, rwkv_decay_lora=16,
        param_dtype="float32", compute_dtype="float32",
    )

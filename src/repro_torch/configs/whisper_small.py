"""Whisper-small — encoder-decoder audio backbone [arXiv:2212.04356].

The same numbers as ``repro.configs.whisper_small``: d_model 768, 12
encoder and 12 decoder layers, 12 heads of 64 (group 1), GELU FFNs of
3072, LayerNorm with scale and bias, vocab 51865, tied embeddings, bf16 —
238,013,184 parameters.  The mel-spectrogram and conv frontend are a stub:
a batch carries frame embeddings [B, 1500, 768], to which the encoder adds
sinusoidal positions.  The decoder's tokens get no positions
(``rope_type="none"``): the reference's code adds none, though its
docstring speaks of sinusoidal decoder positions, and the port follows the
code.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        arch_type="audio",
        citation="arXiv:2212.04356",
        d_model=768,
        n_layers=12,                  # decoder layers
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        stack=((12, (LayerSpec("attn", "dense", cross_attn=True),)),),
        ffn_kind="gelu",
        norm="layernorm",
        rope_type="none",
        tie_embeddings=True,
        encoder_layers=12,
        n_audio_ctx=1500,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        dp_microbatch=16,
        remat=True,
        optimizer="adamw",
        lr=1e-4,
        long_context_mode="skip",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        stack=((2, (LayerSpec("attn", "dense", cross_attn=True),)),),
        encoder_layers=2, n_audio_ctx=64,
        param_dtype="float32", compute_dtype="float32",
    )

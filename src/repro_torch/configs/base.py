"""ModelConfig schema, copied from ``repro.configs.base`` with torch dtypes.

The fields are the reference's, so a config reads the same in both
packages; ``pdtype``/``cdtype`` return ``torch.dtype``s where the
reference returns ``jnp.dtype``s.  Every field has the reference's
default, and ``param_count`` and ``active_param_count`` are the
reference's formulas (which leave out the norms' parameters, MLA's latent
norms and the MTP subtree).
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"       # attn | mla | mamba | rwkv6
    ffn: str = "dense"        # dense | moe
    cross_attn: bool = False  # whisper decoder blocks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # (repeat, pattern) groups; sum(repeat*len(pattern)) == n_layers
    stack: tuple[tuple[int, tuple[LayerSpec, ...]], ...] = ()
    ffn_kind: str = "swiglu"             # swiglu | geglu | relu2 | gelu
    norm: str = "rmsnorm"                # rmsnorm | layernorm | ln_nonparam
    rope_type: str = "standard"          # standard | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (0, 0, 0)
    tie_embeddings: bool = True
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1
    router_aux_coef: float = 0.01
    # --- MLA (DeepSeek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MTP (DeepSeek-V3 multi-token prediction; opt-in) ---
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3
    # --- Mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0
    # --- RWKV6 ---
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_chunk_impl: str = "states"
    rwkv_chunk: int = 32
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    n_audio_ctx: int = 0
    # --- VLM ---
    vision_prefix_frac: float = 0.0
    # --- attention windows ---
    sliding_window: int | None = None
    long_context_window: int | None = None
    # --- dtypes / perf ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    use_flash: bool = False
    use_decode_kernel: bool = False
    remat: bool = False
    scan_layers: bool = True
    # --- training defaults ---
    optimizer: str = "adamw"
    lr: float = 3e-4
    dp_clip: float = 1.0
    dp_sigma: float = 1.0
    dp_microbatch: int = 1
    ghost_chunk: int = 64
    long_context_mode: str = "window"

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def stack_layers(self) -> int:
        return sum(r * len(p) for r, p in self.stack)

    def validate(self) -> None:
        if not self.stack:
            raise ValueError(f"{self.name}: stack must be defined")
        if self.stack_layers() != self.n_layers:
            raise ValueError(f"{self.name}: stack layers "
                             f"{self.stack_layers()} != n_layers "
                             f"{self.n_layers}")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_stack(n_layers: int, ffn: str = "dense") -> tuple:
    return ((n_layers, (LayerSpec("attn", ffn),)),)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (the reference's formula)."""
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d  # embeddings
    if not cfg.tie_embeddings:
        total += v * d
    enc_layers = cfg.encoder_layers

    def attn_params():
        return d * cfg.n_heads * cfg.head_dim * 2 + d * cfg.n_kv_heads * cfg.head_dim * 2

    def mla_params():
        return (
            d * cfg.q_lora_rank
            + cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            + d * cfg.kv_lora_rank
            + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            + d * cfg.qk_rope_dim
            + cfg.n_heads * cfg.v_head_dim * d
        )

    def mamba_params():
        di = cfg.mamba_expand * d
        return (
            d * 2 * di + cfg.mamba_d_conv * di
            + di * (2 * cfg.mamba_d_state + cfg.mamba_dt_rank)
            + cfg.mamba_dt_rank * di + di * cfg.mamba_d_state + 2 * di + di * d
        )

    def rwkv_params():
        return 5 * d * d + 2 * d * cfg.rwkv_decay_lora + 2 * d

    def ffn_params(kind: str):
        if kind == "moe":
            per_exp = 3 * d * cfg.expert_d_ff
            shared = 3 * d * cfg.expert_d_ff * cfg.n_shared_experts
            return cfg.n_experts * per_exp + shared + d * cfg.n_experts
        gated = cfg.ffn_kind in ("swiglu", "geglu")
        return (3 if gated else 2) * d * cfg.d_ff

    mixer_fns = {"attn": attn_params, "mla": mla_params,
                 "mamba": mamba_params, "rwkv6": rwkv_params}
    for repeat, pattern in cfg.stack:
        for spec in pattern:
            total += repeat * (mixer_fns[spec.mixer]() + ffn_params(spec.ffn))
            if spec.cross_attn:
                total += repeat * attn_params()
    total += enc_layers * (attn_params() + ffn_params("dense"))
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Params active per token (MoE: top-k + shared experts only)."""
    if cfg.n_experts == 0:
        return param_count(cfg)
    full = param_count(cfg)
    d = cfg.d_model
    per_exp = 3 * d * cfg.expert_d_ff
    n_moe_layers = sum(
        r for r, p in cfg.stack for s in p if s.ffn == "moe"
    )
    inactive = n_moe_layers * (cfg.n_experts - cfg.moe_top_k) * per_exp
    return full - inactive

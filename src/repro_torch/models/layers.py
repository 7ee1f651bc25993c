"""Primitive layers: initialisers, RMSNorm, RoPE and the FFN kinds.

Counterpart of ``repro.models.layers``.  The port keeps its parameters in
plain dicts of tensors under its own short names; ``pname`` stays so that
``repro_torch.convert`` can spell the reference's axis-encoded keys
(``"wq|embed,qheads"``).  ``shard`` is left out: without a mesh the
reference's is the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pname(name: str, *axes: str) -> str:
    """Encode logical axes into a parameter key, as the reference does."""
    return f"{name}|{','.join(axes)}"


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul`` does.

    Training steps float32 gradients into bfloat16 parameters, so after
    the first round the parameters are float32 while activations may be
    bfloat16; the reference promotes such products, and torch's ``@``
    refuses mixed dtypes.
    """
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def trunc_normal(shape, dtype: torch.dtype, stddev: float,
                 generator: torch.Generator) -> torch.Tensor:
    """``stddev`` times a unit normal truncated to [-2, 2], drawn in float32.

    Like ``jax.random.truncated_normal`` followed by ``* stddev``: the
    truncation is in units of the unit normal and the variance is not
    renormalised (so the std is about 0.88 * stddev).  Not
    ``trunc_normal_(std=stddev)``, which truncates at +-2 in absolute units.
    """
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (stddev * x).to(dtype)


def dense_init(d_in: int, shape, dtype: torch.dtype,
               generator: torch.Generator) -> torch.Tensor:
    return trunc_normal(shape, dtype, 1.0 / math.sqrt(d_in), generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm over the last axis in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Gated FFN variants
# ---------------------------------------------------------------------------

def _act(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    if kind in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if kind == "relu2":  # Nemotron squared-ReLU
        return torch.square(F.relu(x))
    raise ValueError(f"unknown ffn kind {kind!r}")


def ffn_init(d_model: int, d_ff: int, kind: str, dtype: torch.dtype,
             generator: torch.Generator) -> dict:
    """kind: swiglu | geglu | relu2 | gelu (non-gated kinds: up+down only)."""
    if kind not in ("swiglu", "geglu", "relu2", "gelu"):
        raise ValueError(f"unknown ffn kind {kind!r}")
    p = {}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(d_model, (d_model, d_ff), dtype, generator)
    p["w_up"] = dense_init(d_model, (d_model, d_ff), dtype, generator)
    p["w_down"] = dense_init(d_ff, (d_ff, d_model), dtype, generator)
    return p


def ffn_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = matmul(x, p["w_up"])
    if kind in ("swiglu", "geglu"):
        h = _act(kind, matmul(x, p["w_gate"])) * up
    else:
        h = _act(kind, up)
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].

    Rotate-half on the two halves of D, angles in float32, result cast
    back to ``x``'s dtype.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # [D/2]
    ang = positions[..., None].float() * inv                   # [..., S, D/2]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)

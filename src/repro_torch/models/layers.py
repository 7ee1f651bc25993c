"""Primitive layers: initialisers, the norms, RoPE / M-RoPE, the FFN kinds
and Whisper's sinusoidal positions.

Counterpart of ``repro.models.layers``.  The port keeps its parameters in
plain dicts of tensors under its own short names; ``pname`` and
``logical_axes`` stay so that ``repro_torch.convert`` can spell the
reference's axis-encoded keys (``"wq|embed,qheads"``) and
``launch.sharding`` can read the logical axes back out of them.

``shard(x, *axes)`` is the reference's activation hint.  Without rules
(``activation_sharding``) or on a plain tensor it returns ``x`` itself, so
nothing on a one-card path changes; on a DTensor under rules (also one
under ``torch.func``'s transforms) it redistributes ``x`` to the
placements the reference's rule gives.  ``split_dim`` is a view that
first makes whole what DTensor could not split evenly; the placements
DTensor cannot find by itself are ``models.placement``'s.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.models.placement import (
    _mesh_of,
    einsum,
    even_splits,
    placements_of,
    redistribute,
)


def pname(name: str, *axes: str) -> str:
    """Encode logical axes into a parameter key, as the reference does."""
    return f"{name}|{','.join(axes)}"


def logical_axes(key: str, ndim: int) -> tuple[str, ...]:
    """Decode logical axes from a param key; prepend 'layers' for stacked."""
    if "|" not in key:
        axes: tuple[str, ...] = ()
    else:
        axes = tuple(a for a in key.split("|")[1].split(",") if a)
    if len(axes) < ndim:  # stacked leaves (a leading layers axis)
        axes = ("layers",) * (ndim - len(axes)) + axes
    return axes


# ---------------------------------------------------------------------------
# Activation sharding: hints are the identity without an active rule set.
# ---------------------------------------------------------------------------

# Per thread: the serve trainer thread and the decode loop both run models
# concurrently, and one thread's rules must not leak into the other's.
_SHARDING = threading.local()


class activation_sharding:
    """Context manager installing logical->mesh rules for activation hints
    (``launch.sharding.activation_rules``)."""

    def __init__(self, rules: dict | None):
        self.rules = rules

    def __enter__(self):
        self._prev = getattr(_SHARDING, "rules", None)
        _SHARDING.rules = self.rules
        return self

    def __exit__(self, *exc):
        _SHARDING.rules = self._prev
        return False


def activation_spec(shape, axes, rules: dict) -> tuple:
    """The reference's hint rule as a spec: mesh axes may appear in at most
    one position (earlier logical axes win) and a dim its mesh extent does
    not divide is replicated."""
    names = rules["__mesh__"].mesh_dim_names
    used: set = set()
    entries = []
    for dim, a in zip(shape, axes):
        mesh_ax = rules.get(a) if a else None
        flat = tuple(mesh_ax) if isinstance(mesh_ax, tuple) else (mesh_ax,)
        size = math.prod(rules["__mesh__"].size(names.index(m))
                         for m in flat if m) if mesh_ax else 1
        if mesh_ax is None or any(m in used for m in flat) or dim % size:
            entries.append(None)
        else:
            entries.append(mesh_ax)
            used.update(flat)
    return tuple(entries)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Hint activation ``x``'s logical axes (identity without rules or on
    a plain tensor): a DTensor is redistributed to the placements of
    ``activation_spec``, under ``torch.func`` transforms too
    (``redistribute``)."""
    rules = getattr(_SHARDING, "rules", None)
    if rules is None or placements_of(x) is None:
        return x
    from repro_torch.launch.sharding import to_placements  # rules only

    mesh = rules["__mesh__"]
    return redistribute(x, to_placements(
        activation_spec(x.shape, axes, rules), mesh))


def token_axis() -> str:
    """The logical axis of the tokens' split across ranks: "batch", or
    "seq" under rules that keep the batch whole and split the sequence
    (the per-example rules: a microbatch's few examples, each split along
    its sequence), where a grouping of the tokens in order (the MoE
    groups) follows the sequence's split."""
    rules = getattr(_SHARDING, "rules", None)
    if rules and rules.get("batch") is None and rules.get("seq"):
        return "seq"
    return "batch"


def split_dim(x: torch.Tensor, dim: int, n: int, rest: int) -> torch.Tensor:
    """``x`` with dim ``dim`` (of size n * rest) split into (n, rest): a
    view of a plain tensor.

    A DTensor whose ``dim`` its mesh dims split into a number of blocks
    that does not divide ``n`` is first made whole over the mesh dims
    past the last one whose running product of extents divides ``n``:
    split heads that could not be sharded evenly (smollm's 15 heads over
    2 model ranks), or 16 MoE groups of tokens split 32 ways over
    ("pod", "data"), where GSPMD reshards without being asked and
    DTensor refuses the view.  Under ``torch.func`` transforms as well
    (``placements_of``, ``redistribute``)."""
    dim %= x.ndim
    placements = placements_of(x)
    if placements is not None:
        x = redistribute(x, even_splits(placements, _mesh_of(x), dim, n))
    return x.reshape(x.shape[:dim] + (n, rest) + x.shape[dim + 1:])


def split_last(x: torch.Tensor, n: int, rest: int) -> torch.Tensor:
    """``x`` [..., n * rest] as [..., n, rest] (``split_dim``)."""
    return split_dim(x, -1, n, rest)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul`` does.

    Training steps float32 gradients into bfloat16 parameters, so after
    the first round the parameters are float32 while activations may be
    bfloat16; the reference promotes such products, and torch's ``@``
    refuses mixed dtypes.

    A DTensor under ``torch.func`` times a weight multiplies on each
    rank's blocks (``placement.einsum``): ``@`` flattens the leading dims,
    and where the sequence is split under the unsplit examples of a
    ``vmap`` (the per-example rules) that flat dim is a strided split,
    which torch's redistribute planner searches for minutes.  The
    activation's splits come first (``keep_a``): a weight larger than one
    example's activation is gathered where its FSDP split would otherwise
    make the activation's split sequence whole.
    """
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if b.ndim == 2 and a.ndim > 2 and not hasattr(a, "placements") and \
            placements_of(a) is not None:
        rows = "abcdefgh"[:a.ndim]
        return einsum(f"{rows},{rows[-1]}z->{rows[:-1]}z", a, b,
                      keep_a=True)
    return a @ b


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def init_device(generator: torch.Generator | None) -> torch.device:
    """Where an initializer puts its leaves: the generator's device, or the
    meta device when there is no generator (a shape-only init: every leaf
    has its shape and dtype and no storage, and nothing is drawn)."""
    return torch.device("meta") if generator is None else generator.device


def trunc_normal(shape, dtype: torch.dtype, stddev: float,
                 generator: torch.Generator | None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``stddev`` times a unit normal truncated to [-2, 2], drawn in float32.

    Like ``jax.random.truncated_normal`` followed by ``* stddev``: the
    truncation is in units of the unit normal and the variance is not
    renormalised (so the std is about 0.88 * stddev).  Not
    ``trunc_normal_(std=stddev)``, which truncates at +-2 in absolute units.
    Returns a new tensor of ``dtype``, or, given ``out``, casts the draw
    into it and returns it.  Without a generator nothing is drawn: the
    leaf is a meta tensor of the shape and dtype (``init_device``).
    """
    if generator is None:
        return (torch.empty(shape, dtype=dtype, device="meta")
                if out is None else out)
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    x.mul_(stddev)
    return x.to(dtype) if out is None else out.copy_(x)


def dense_init(d_in: int, shape, dtype: torch.dtype,
               generator: torch.Generator | None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    return trunc_normal(shape, dtype, 1.0 / math.sqrt(d_in), generator, out)


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


def layernorm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale, no bias), in float32,
    cast back to ``x``'s dtype; the variance is the mean squared deviation,
    as ``jnp.var`` computes it."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Parametric LayerNorm (Whisper's), in the reference's order: the
    non-parametric norm cast back to ``x``'s dtype, then scale and bias in
    float32, cast again.  In bfloat16 the middle rounding is part of the
    result."""
    y = layernorm_nonparam(x, eps).float()
    y = y * scale.float()
    y = y + bias.float()
    return y.to(x.dtype)


NORMS = ("rmsnorm", "ln_nonparam", "layernorm")


def make_norm(kind: str, d: int, dtype: torch.dtype, device
              ) -> torch.Tensor | None:
    """The norm's scale: a [d] tensor of ones for ``rmsnorm`` and
    ``layernorm``, None for ``ln_nonparam`` (which has none)."""
    if kind in ("rmsnorm", "layernorm"):
        return torch.ones(d, dtype=dtype, device=device)
    if kind == "ln_nonparam":
        return None
    raise ValueError(f"unknown norm {kind!r}")


def make_norm_bias(kind: str, d: int, dtype: torch.dtype, device
                   ) -> torch.Tensor | None:
    """The norm's bias: [d] zeros for ``layernorm``, None for the others.
    A model keeps it beside the scale, under the scale's name + ``_bias``."""
    return torch.zeros(d, dtype=dtype, device=device) \
        if kind == "layernorm" else None


def apply_norm(kind: str, scale: torch.Tensor | None, x: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The configured norm of ``x`` (``scale`` from ``make_norm``, ``bias``
    from ``make_norm_bias``)."""
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    if kind == "ln_nonparam":
        return layernorm_nonparam(x)
    if kind == "layernorm":
        return layernorm(x, scale, bias)
    raise ValueError(f"unknown norm {kind!r}")


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
             generator: torch.Generator | None, out: dict | None = None
             ) -> dict:
    """kind: swiglu | geglu | relu2 | gelu (non-gated kinds: up+down only).
    ``out`` (name -> tensor) receives the draws in place."""
    if kind not in ("swiglu", "geglu", "relu2", "gelu"):
        raise ValueError(f"unknown ffn kind {kind!r}")
    o = out or {}
    p = {}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(d_model, (d_model, d_ff), dtype, generator,
                                 o.get("w_gate"))
    p["w_up"] = dense_init(d_model, (d_model, d_ff), dtype, generator,
                           o.get("w_up"))
    p["w_down"] = dense_init(d_ff, (d_ff, d_model), dtype, generator,
                             o.get("w_down"))
    return p


def ffn_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = matmul(x, p["w_up"])
    if kind in ("swiglu", "geglu"):
        h = _act(kind, matmul(x, p["w_gate"])) * up
    else:
        h = _act(kind, up)
    h = shard(h, "batch", None, "mlp")
    return matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, d: int, theta: float
                ) -> torch.Tensor:
    """Standard RoPE's float32 angles [..., S, D/2] at ``positions``."""
    return positions[..., None].float() * rope_freqs(d, theta,
                                                     positions.device)


def mrope_angles(positions_3d: torch.Tensor, d: int, theta: float,
                 sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's M-RoPE angles [B, S, D/2]: frequency bands split across
    (t, h, w).  positions_3d: [B, S, 3] (temporal, height, width ids).
    ``sections`` gives the number of frequency pairs per component; pair i
    takes its angle from component 0 below ``sections[0]``, 1 below
    ``sections[0] + sections[1]`` and 2 above (pairs past the sum too, as
    the reference's ``total_repeat_length`` fills them).  The section ids
    come from comparisons on the device, so nothing is copied from the
    host."""
    dev = positions_3d.device
    pair = torch.arange(d // 2, device=dev)
    sec_ids = ((pair >= sections[0]).long()
               + (pair >= sections[0] + sections[1]).long())   # [D/2]
    pos = positions_3d.float().index_select(-1, sec_ids)       # [B, S, D/2]
    return pos * rope_freqs(d, theta, dev)


def rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
           ) -> torch.Tensor:
    """Rotate-half of x [..., S, H, D] by angles whose sine and cosine are
    [..., S, 1, D/2]; the result in ``x``'s dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sin_cos(ang: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., S, D/2] angles -> their sine and cosine as [..., S, 1, D/2]."""
    return torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].

    Rotate-half on the two halves of D, angles in float32, result cast
    back to ``x``'s dtype.
    """
    return rotate(x, *sin_cos(rope_angles(positions, x.shape[-1], theta)))


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE of x [B, S, H, D] at positions_3d [B, S, 3]
    (``mrope_angles``)."""
    return rotate(x, *sin_cos(mrope_angles(positions_3d, x.shape[-1], theta,
                                           sections)))


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings [n, d] in float32: sines in
    the even columns, cosines in the odd, at angles pos / 10000^(2i/d)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = torch.zeros((n, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out

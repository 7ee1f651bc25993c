"""State-space mixers: Mamba-1's selective scan and RWKV6 ("Finch").

Counterpart of ``repro.models.ssm``.  Both recurrences are linear with a
diagonal transition, h_t = a_t * h_{t-1} + b_t, so a sequence is scanned in
chunks: inside a chunk an inclusive scan of the elementwise combine
(``_diag_scan``), across chunks a Python loop carries the boundary state.
Decoding is the one-step recurrence on an O(1) state per row.

  * Mamba-1: ``mamba_init``, ``mamba_apply`` (``_causal_conv``, the chunked
    ``_ssm_scan``), ``mamba_init_cache`` and ``mamba_decode``;
  * RWKV6: ``rwkv6_init``, ``rwkv6_apply`` (``_rwkv_proj``'s token shift and
    decay LoRA, then ``_rwkv_wkv_scan``, the default, or
    ``_rwkv_wkv_scan_quadratic`` with ``cfg.rwkv_chunk_impl ==
    "quadratic"``), ``rwkv6_init_cache`` and ``rwkv6_decode``.

The reference's in-chunk scan is ``jax.lax.associative_scan`` (an
odd-even tree); the port's is a Hillis-Steele scan, ceil(log2(chunk))
elementwise steps, with the same combine in another order of float
operations.  No Pallas kernel lies here: the reference leaves both scans
to XLA, and the port to plain PyTorch.  Every op is out of place and
nothing waits for the host, so the scans run under ``torch.func.vmap``
(the faithful per-example DP path; the ghost path excludes both mixers,
as the reference's does) and a decode step needs no host sync.

Dtypes are the reference's: the scans, ``a_log``, ``d_skip``, the decay,
``bonus_u`` and ``token_mix`` in float32, the conv and token-shift caches
in the compute dtype, the recurrent states in float32.  ``mamba_decode``
and ``rwkv6_decode`` write the new state into the cache tensors they were
given, in place, as ``attention.gqa_decode`` writes its K and V rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, init_device, matmul,
                                       shard, split_last)
from repro_torch.models.placement import einsum, merge_dims, on_local_shards


def _draw(t: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """``t``, or ``out`` with ``t`` copied into it."""
    return t if out is None else out.copy_(t)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of the two, as ``jnp.einsum``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return einsum(eq, a.to(dt), b.to(dt))


def _diag_scan(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of h_t = a_t h_{t-1} + b_t from h = 0:
    (prod_{s<=t} a_s, h_t).  ``a`` broadcasts against ``b``.  Hillis-Steele:
    at step d each position t >= d combines with t - d, out of place."""
    n, d = b.shape[1], 1
    while d < n:
        a_lo, a_hi = a[:, :n - d], a[:, d:]
        b = torch.cat([b[:, :d], a_hi * b[:, :n - d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_hi * a_lo], dim=1)
        d *= 2
    return a, b


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``t`` [B,S,...] with ``pad`` positions of ``value`` after S."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)


def _chunks(s: int, chunk: int) -> tuple[int, int]:
    """(chunk length, padded positions) for a sequence of ``s``."""
    chunk = min(chunk, s)
    return chunk, -s % chunk


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM)
# ---------------------------------------------------------------------------

def mamba_init(cfg, dtype: torch.dtype, generator: torch.Generator | None,
               out: dict | None = None) -> dict:
    """The reference's leaves and laws; ``out`` (name -> tensor) receives
    the draws in place."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds, dconv, dt_rank = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.mamba_dt_rank
    o = out or {}
    dev = init_device(generator)
    p = {
        "w_in": dense_init(d, (d, 2 * di), dtype, generator, o.get("w_in")),
        "conv_w": dense_init(dconv, (dconv, di), dtype, generator,
                             o.get("conv_w")),
        "conv_b": _draw(torch.zeros(di, dtype=dtype, device=dev),
                        o.get("conv_b")),
        "w_bcdt": dense_init(di, (di, 2 * ds + dt_rank), dtype, generator,
                             o.get("w_bcdt")),
        "w_dt": dense_init(dt_rank, (dt_rank, di), dtype, generator,
                           o.get("w_dt")),
    }
    # dt = exp(U * (log 0.1 - log 0.001) + log 0.001), clipped at 1e-4, and
    # the bias is softplus's inverse of it
    u = torch.rand(di, generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p["dt_bias"] = _draw(torch.log(torch.expm1(dt.clamp(min=1e-4))).to(dtype),
                         o.get("dt_bias"))
    p["a_log"] = _draw(torch.log(torch.arange(
        1, ds + 1, dtype=torch.float32, device=dev)).expand(di, ds).clone(),
        o.get("a_log"))
    p["d_skip"] = _draw(torch.ones(di, dtype=torch.float32, device=dev),
                        o.get("d_skip"))
    p["w_out"] = dense_init(di, (di, d), dtype, generator, o.get("w_out"))
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv along S.  x: [B,S,DI]; w: [K,DI]; b: [DI]."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s] * w[i] for i in range(k)) + b


def _ssm_scan(u, dt, a, b, c, chunk: int = 256) -> torch.Tensor:
    """Chunked selective scan.  u, dt: [B,S,DI]; a: [DI,DS]; b, c: [B,S,DS].

    h_t = exp(dt_t A) h_{t-1} + (dt_t B_t) u_t;  y_t = C_t . h_t.  The
    sequence is cut into chunks (padded steps have dt = 0, the identity),
    so the [B, L, DI, DS] working set is bounded by the chunk.
    """
    bsz, s = u.shape[:2]
    chunk, pad = _chunks(s, chunk)
    if pad:
        u, dt, b, c = (_pad_seq(t, pad) for t in (u, dt, b, c))
    h = torch.zeros((bsz, *a.shape), dtype=u.dtype, device=u.device)
    ys = []
    for start in range(0, u.shape[1], chunk):
        sl = slice(start, start + chunk)
        u_i, dt_i, b_i, c_i = u[:, sl], dt[:, sl], b[:, sl], c[:, sl]
        da = torch.exp(dt_i[..., None] * a)                     # [B,L,DI,DS]
        dbu = (dt_i * u_i)[..., None] * b_i[:, :, None, :]      # [B,L,DI,DS]
        a_cum, h_rel = _diag_scan(da, dbu)
        hs = a_cum * h[:, None] + h_rel
        ys.append(einsum("bldn,bln->bld", hs, c_i))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :s]


def mamba_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence Mamba-1 mixer.  x: [B,S,D] -> [B,S,D]."""
    di = cfg.mamba_expand * cfg.d_model
    ds = cfg.mamba_d_state
    xz = matmul(x, p["w_in"])
    xi, z = xz[..., :di], xz[..., di:]
    xi = shard(xi, "batch", None, "mlp")
    xi = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    bcdt = matmul(xi, p["w_bcdt"])
    b, c = bcdt[..., :ds], bcdt[..., ds:2 * ds]
    dt = F.softplus(matmul(bcdt[..., 2 * ds:], p["w_dt"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    rows, inner = {"batch": 0, "heads": 2}, {"heads": 0}
    y, = on_local_shards(
        lambda *xs: (_ssm_scan(*xs),),
        (xi.float(), dt.float(), a, b.float(), c.float()),
        (rows, rows, inner, {"batch": 0}, {"batch": 0}), (rows,))
    y = y + xi.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return matmul(y, p["w_out"])


def mamba_init_cache(cfg, batch: int, dtype: torch.dtype, device) -> dict:
    di = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg
                 ) -> tuple[torch.Tensor, dict]:
    """One step of the recurrence.  x: [B,1,D]; cache ``conv`` [B,K-1,DI]
    and ``ssm`` [B,DI,DS], both updated in place."""
    di = cfg.mamba_expand * cfg.d_model
    ds = cfg.mamba_d_state
    xz = matmul(x, p["w_in"])
    xi, z = xz[..., :di], xz[..., di:]
    hist = torch.cat([cache["conv"], xi.to(cache["conv"].dtype)], dim=1)
    conv = _einsum("bkd,kd->bd", hist, p["conv_w"])[:, None] + p["conv_b"]
    xi_c = F.silu(conv)
    bcdt = matmul(xi_c, p["w_bcdt"])
    b, c = bcdt[..., :ds], bcdt[..., ds:2 * ds]
    dt = F.softplus(matmul(bcdt[..., 2 * ds:], p["w_dt"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[:, 0, :, None].float() * a)                # [B,DI,DS]
    dbu = (dt * xi_c)[:, 0, :, None].float() * b[:, 0, None, :].float()
    h = da * cache["ssm"] + dbu
    y = einsum("bdn,bn->bd", h, c[:, 0].float())[:, None]
    y = y + xi_c.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(h)
    return matmul(y, p["w_out"]), cache


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay linear attention
# ---------------------------------------------------------------------------

def rwkv6_init(cfg, dtype: torch.dtype, generator: torch.Generator | None,
               out: dict | None = None) -> dict:
    """The reference's leaves and laws; ``out`` (name -> tensor) receives
    the draws in place."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    nh = d // hs
    lora = cfg.rwkv_decay_lora
    o = out or {}
    dev = init_device(generator)
    p = {name: dense_init(d, (d, d), dtype, generator, o.get(name))
         for name in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    # the decay w_t = exp(-exp(w0 + tanh(x W_a) W_b))
    p["decay_w0"] = _draw(
        -6.0 + torch.rand(d, generator=generator, device=dev),
        o.get("decay_w0"))
    p["decay_wa"] = dense_init(d, (d, lora), dtype, generator,
                               o.get("decay_wa"))
    p["decay_wb"] = dense_init(lora, (lora, d), dtype, generator,
                               o.get("decay_wb"))
    p["bonus_u"] = _draw(torch.zeros((nh, hs), dtype=torch.float32,
                                     device=dev), o.get("bonus_u"))
    p["token_mix"] = _draw(torch.full((5, d), 0.5, dtype=torch.float32,
                                      device=dev), o.get("token_mix"))
    return p


def _rwkv_wkv_scan_quadratic(r, k, v, w, u, chunk: int = 32):
    """GLA-style chunked linear attention: inside a chunk two [L, L]
    products with decay-factorised queries and keys (r~ = r exp(cum_excl),
    k~ = k exp(-cum)); full [NH, HS, HS] states only at chunk boundaries.
    Safe while a chunk's decay products stay in float32's range.
    r, k, v, w: [B,S,NH,HS]; u: [NH,HS] -> (y [B,S,NH,HS], final state)."""
    s = r.shape[1]
    chunk, pad = _chunks(s, chunk)
    if pad:
        r, k, v = (_pad_seq(t, pad) for t in (r, k, v))
        w = _pad_seq(w, pad, 1.0)
    b_dim, _, nh, hs = r.shape
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=r.device), diagonal=-1)  # strict
    s0 = torch.zeros((b_dim, nh, hs, hs), dtype=r.dtype, device=r.device)
    ys = []
    for r_i, k_i, v_i, w_i in zip(*(t.split(chunk, dim=1)
                                    for t in (r, k, v, w))):
        lw = torch.log(torch.clamp(w_i, min=1e-30))
        ca = torch.cumsum(lw, dim=1)                  # inclusive
        cae = ca - lw                                 # exclusive
        r_dec = r_i * torch.exp(cae)
        k_dec = k_i * torch.exp(-ca)
        y_inter = einsum("blnk,bnkv->blnv", r_dec, s0)
        scores = einsum("blnk,bmnk->bnlm", r_dec, k_dec) * mask
        y_intra = einsum("bnlm,bmnv->blnv", scores, v_i)
        bonus = torch.sum(r_i * u * k_i, dim=-1)      # [B,L,NH]
        ys.append(y_inter + y_intra + bonus[..., None] * v_i)
        k_tail = k_i * torch.exp(ca[:, -1:] - ca)     # k * prod_{>tau} w
        s0 = torch.exp(ca[:, -1])[..., None] * s0 + einsum(
            "blnk,blnv->bnkv", k_tail, v_i)
    return torch.cat(ys, dim=1)[:, :s], s0


def _rwkv_wkv_scan(r, k, v, w, u, chunk: int = 32):
    """r, k, v: [B,S,NH,HS]; w (decay in (0, 1)): [B,S,NH,HS]; u: [NH,HS].

    S_t = diag(w_t) S_{t-1} + k_t v_t^T;  y_t = r_t . (S_{t-1} + diag(u)
    k_t v_t^T).  Chunked scan of the [B, L, NH, HS, HS] outer products; the
    exclusive-prefix state S_{t-1} comes from shifting the inclusive one by
    a position inside the chunk, never from dividing by a decay (RWKV decays
    can be tiny).  Returns (y [B,S,NH,HS], the final state)."""
    s = r.shape[1]
    chunk, pad = _chunks(s, chunk)
    if pad:
        r, k, v = (_pad_seq(t, pad) for t in (r, k, v))
        w = _pad_seq(w, pad, 1.0)
    b_dim, _, nh, hs = r.shape
    s0 = torch.zeros((b_dim, nh, hs, hs), dtype=r.dtype, device=r.device)
    ukv = u[:, :, None]
    ys = []
    for r_i, k_i, v_i, w_i in zip(*(t.split(chunk, dim=1)
                                    for t in (r, k, v, w))):
        kv = einsum("blnk,blnv->blnkv", k_i, v_i)  # [B,L,NH,HS,HS]
        # the decay of row k of a state is the same for every column v
        a_cum, s_rel = _diag_scan(w_i[..., None], kv)
        s_all = a_cum * s0[:, None] + s_rel
        s_prev = torch.cat([s0[:, None], s_all[:, :-1]], dim=1)
        ys.append(einsum("blnk,blnkv->blnv", r_i, s_prev + ukv * kv))
        s0 = s_all[:, -1]
    return torch.cat(ys, dim=1)[:, :s], s0


def _rwkv_proj(p: dict, x: torch.Tensor, x_prev: torch.Tensor, cfg):
    """Token-shift mixed projections.  x, x_prev (shifted): [B,S,D] ->
    r, k, v [B,S,NH,HS], the gate g [B,S,D] and the float32 decay w
    [B,S,NH,HS].  The five mixes x * m_i + x_prev * (1 - m_i) are taken in
    one broadcast over a leading axis of 5, the reference's arithmetic in
    a fifth of the launches."""
    mix = p["token_mix"].to(x.dtype)[:, None, None, :]          # [5,1,1,D]
    xs = x * mix + x_prev * (1.0 - mix)                          # [5,B,S,D]
    hs = cfg.rwkv_head_size
    nh = cfg.d_model // hs
    r = split_last(matmul(xs[0], p["w_r"]), nh, hs)
    k = split_last(matmul(xs[1], p["w_k"]), nh, hs)
    v = split_last(matmul(xs[2], p["w_v"]), nh, hs)
    g = F.silu(matmul(xs[3], p["w_g"]))
    dec = p["decay_w0"] + matmul(torch.tanh(matmul(xs[4], p["decay_wa"])),
                                 p["decay_wb"])
    w = split_last(torch.exp(-torch.exp(dec.float())), nh, hs)
    return r, k, v, g, w


def rwkv6_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence RWKV6 time mix.  x: [B,S,D] -> [B,S,D]."""
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _rwkv_proj(p, x, x_prev, cfg)
    scan = (_rwkv_wkv_scan_quadratic if cfg.rwkv_chunk_impl == "quadratic"
            else _rwkv_wkv_scan)
    rows = {"batch": 0, "heads": 2}
    y, _ = on_local_shards(
        lambda *xs: scan(*xs, chunk=cfg.rwkv_chunk),
        (r.float(), k.float(), v.float(), w, p["bonus_u"]),
        (rows, rows, rows, rows, {"heads": 0}),
        (rows, {"batch": 0, "heads": 1}))
    y = merge_dims(y).to(x.dtype) * g.to(x.dtype)
    return matmul(y, p["w_o"]).to(x.dtype)


def rwkv6_init_cache(cfg, batch: int, dtype: torch.dtype, device) -> dict:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    return {
        "x_prev": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32,
                           device=device),
    }


def rwkv6_decode(p: dict, x: torch.Tensor, cache: dict, cfg
                 ) -> tuple[torch.Tensor, dict]:
    """One step of the recurrence.  x: [B,1,D]; cache ``x_prev`` [B,1,D]
    and ``wkv`` [B,NH,HS,HS], both updated in place."""
    r, k, v, g, w = _rwkv_proj(p, x, cache["x_prev"], cfg)
    r1, k1, v1, w1 = (t[:, 0].float() for t in (r, k, v, w))
    kv = einsum("bnk,bnv->bnkv", k1, v1)
    state = cache["wkv"]
    y = einsum("bnk,bnkv->bnv", r1,
               state + p["bonus_u"][None, :, :, None] * kv)
    s_new = w1[..., None] * state + kv
    y = y.reshape(x.shape).to(x.dtype) * g.to(x.dtype)
    out = matmul(y, p["w_o"]).to(x.dtype)
    cache["x_prev"].copy_(x)
    state.copy_(s_new)
    return out, cache

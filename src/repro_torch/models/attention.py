"""Grouped-query attention: full sequences, and decoding per row.

Counterpart of the GQA half of ``repro.models.attention``.

  * ``gqa_apply`` — full-sequence (training) attention through the
    float32 ``_sdpa`` and an additive ``_causal_mask``: plain products
    that the reference leaves to XLA.  ``use_flash`` (the
    ``flash_attention`` kernel) is not ported yet.
  * ``gqa_decode`` — one token per row.  The reference's ``gqa_decode``
    takes one scalar ``index`` and gets per-slot positions from
    ``jax.vmap`` (``transformer.decode_step_positions``); the port writes
    that batch dimension out: ``index`` is an int32 ``[B]`` tensor on the
    device, and the rope angle, the cache write and the mask of row b all
    use ``index[b]`` without a host sync.

MLA and cross attention are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.layers import apply_rope, dense_init, matmul

NEG_INF = -1e30


def gqa_init(cfg, dtype: torch.dtype, generator: torch.Generator) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(d, (d, h * hd), dtype, generator),
        "wk": dense_init(d, (d, kv * hd), dtype, generator),
        "wv": dense_init(d, (d, kv * hd), dtype, generator),
        "wo": dense_init(h * hd, (h * hd, d), dtype, generator),
    }


def gqa_init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _sdpa(q, k, v, mask):
    """q: [B,S,H,D]; k,v: [B,L,KV,D]; mask: [B,1,S,L] additive or None.

    The model's own plain attention, in float32 (``decode_kernel=False``).
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = q.reshape(b, s, kvh, group, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(),
                          k.float()) / math.sqrt(d)
    if mask is not None:
        scores = scores + mask[:, :, None]  # mask: [B, KV->1, S, L]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _causal_mask(s: int, l: int, offset: int = 0, window: int | None = None,
                 device=None) -> torch.Tensor:
    """Additive float32 [1,1,S,L] mask: query i attends keys j <= i+offset,
    and j > i+offset-window when a window is set."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(l, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, NEG_INF)[None, None]


def gqa_apply(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg, *,
              window: int | None = None, causal: bool = True) -> torch.Tensor:
    """Full-sequence GQA.  x: [B,S,D]; positions: [B,S] -> [B,S,D]."""
    if cfg.use_flash:
        raise NotImplementedError("use_flash needs the flash_attention "
                                  "kernel, which is not ported yet")
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(matmul(x, p["wq"]), h, hd)
    k = _split_heads(matmul(x, p["wk"]), kv, hd)
    v = _split_heads(matmul(x, p["wv"]), kv, hd)
    q, k = rope(q, k, positions, cfg)
    mask = _causal_mask(s, s, 0, window, x.device) if causal else None
    out = _sdpa(q, k, v, mask)
    return matmul(out.reshape(b, s, h * hd), p["wo"])


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, cfg
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding of q and k at ``positions`` (none for ``"none"``)."""
    if cfg.rope_type == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    if cfg.rope_type == "none":
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, index: torch.Tensor,
               cfg, *, window: int | None = None
               ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: [B,1,D]; cache k/v: [B,L,KV,hd]; index: int32 [B].

    Writes row b's new K and V at cache position ``index[b]`` IN PLACE (the
    reference donates the cache buffer to the same effect) and returns
    ``(y, cache)`` with the same cache tensors.  An index outside
    [0, L) is not clamped as JAX's ``dynamic_update_slice`` would clamp
    it; the engine never produces one.
    """
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    q = _split_heads(x @ p["wq"], h, hd)
    k_new = _split_heads(x @ p["wk"], kv, hd)
    v_new = _split_heads(x @ p["wv"], kv, hd)
    q, k_new = rope(q, k_new, index[:, None], cfg)             # pos [B,1]
    rows = (torch.arange(b, device=x.device), index.long())
    k_cache.index_put_(rows, k_new[:, 0].to(k_cache.dtype))
    v_cache.index_put_(rows, v_new[:, 0].to(v_cache.dtype))
    if cfg.use_decode_kernel:
        out = decode_attention(q, k_cache, v_cache, index, window=window)
    else:
        kj = torch.arange(k_cache.shape[1], device=x.device)[None, :]
        pos = index.long()[:, None]
        ok = kj <= pos
        if window is not None:
            ok &= kj > pos - window
        mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, :]  # [B,1,1,L]
        out = _sdpa(q, k_cache, v_cache, mask)
    y = out.reshape(b, 1, h * hd) @ p["wo"]
    return y, cache

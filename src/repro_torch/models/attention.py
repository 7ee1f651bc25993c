"""Grouped-query attention: full sequences, and decoding per row.

Counterpart of the GQA half of ``repro.models.attention``.

  * ``gqa_apply`` — full-sequence attention.  By default the float32
    ``_sdpa`` with an additive ``_causal_mask``: plain products that the
    reference leaves to XLA.  With ``cfg.use_flash``, the reference's
    routing with "tpu" read as "cuda": causal attention on CUDA tensors
    goes to the ``flash_attention`` kernel (forward only, as the
    reference's Pallas kernel has no VJP), everything else (CPU tensors,
    ``causal=False``) to ``_sdpa_blocked``, FlashAttention's algorithm in
    plain PyTorch.
  * ``gqa_decode`` — one token per row.  The reference's ``gqa_decode``
    takes one scalar ``index`` and gets per-slot positions from
    ``jax.vmap`` (``transformer.decode_step_positions``); the port writes
    that batch dimension out: ``index`` is an int32 ``[B]`` tensor on the
    device, and the rope angle, the cache write and the mask of row b all
    use ``index[b]`` without a host sync.

MLA and cross attention are not ported yet.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
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


def _blocked_step(qg, k_blk, v_blk, m_run, l_run, acc, *, start: int,
                  l_orig: int, causal: bool, window: int | None):
    """One KV block of ``_sdpa_blocked``'s online softmax."""
    s, block_k = qg.shape[1], k_blk.shape[1]
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k_blk.float())
    q_pos = torch.arange(s, device=qg.device)
    k_pos = start + torch.arange(block_k, device=qg.device)
    ok = (k_pos < l_orig)[None, :].expand(s, block_k)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(ok, scores, NEG_INF)
    m_cur = torch.amax(scores, dim=-1, keepdim=True)
    m_new = torch.maximum(m_run, m_cur)
    p = torch.where(ok, torch.exp(scores - m_new), 0.0)
    alpha = torch.exp(m_run - m_new)
    l_new = alpha * l_run + torch.sum(p, dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgsl,blkd->bkgsd", p, v_blk.float())
    return m_new, l_new, acc


def _sdpa_blocked(q, k, v, *, causal: bool = True, window: int | None = None,
                  block_k: int = 512):
    """FlashAttention's algorithm in plain PyTorch: a loop over KV blocks
    with an online softmax, each block's body under ``torch.utils.checkpoint``
    so the backward recomputes its probabilities instead of keeping the
    full [.., S, L] scores (the reference ``jax.checkpoint``s its scan body).

    q: [B,S,H,D]; k,v: [B,L,KV,D] -> [B,S,H,D].  L is padded to a multiple
    of ``block_k`` and the pad masked.  The checkpoint is skipped where it
    saves nothing (no gradient is being recorded) and inside ``torch.func``
    transforms, which refuse its saved-tensor hooks (the faithful
    per-example DP path vmaps ``grad``); the values are the same.
    """
    b, s, h, d = q.shape
    l, kvh = k.shape[1], k.shape[2]
    l_orig = l
    group = h // kvh
    block_k = min(block_k, l)
    if l % block_k:
        pad = block_k - l % block_k
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        l = k.shape[1]
    qg = q.reshape(b, s, kvh, group, d).float() / math.sqrt(d)
    stats = (torch.full((b, kvh, group, s, 1), NEG_INF, device=q.device),
             torch.zeros((b, kvh, group, s, 1), device=q.device),
             torch.zeros((b, kvh, group, s, d), device=q.device))
    recompute = (torch.is_grad_enabled()
                 and not torch._C._are_functorch_transforms_active())
    for start in range(0, l, block_k):
        step = functools.partial(_blocked_step, start=start, l_orig=l_orig,
                                 causal=causal, window=window)
        blk = (qg, k[:, start:start + block_k], v[:, start:start + block_k],
               *stats)
        stats = checkpoint(step, *blk, use_reentrant=False) if recompute \
            else step(*blk)
    _, l_run, acc = stats
    out = acc / torch.clamp(l_run, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


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
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(matmul(x, p["wq"]), h, hd)
    k = _split_heads(matmul(x, p["wk"]), kv, hd)
    v = _split_heads(matmul(x, p["wv"]), kv, hd)
    q, k = rope(q, k, positions, cfg)
    if cfg.use_flash:
        if causal and q.device.type == "cuda":
            out = flash_attention(q, k, v, causal=True, window=window)
        else:
            out = _sdpa_blocked(q, k, v, causal=causal, window=window)
    else:
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
    q = _split_heads(matmul(x, p["wq"]), h, hd)
    k_new = _split_heads(matmul(x, p["wk"]), kv, hd)
    v_new = _split_heads(matmul(x, p["wv"]), kv, hd)
    q, k_new = rope(q, k_new, index[:, None], cfg)             # pos [B,1]
    # attention runs in the cache's dtype (the kernel takes one dtype):
    # a no-op unless float32 parameters promoted the products above a
    # bfloat16 compute dtype, a pair the reference refuses to decode
    q = q.to(k_cache.dtype)
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
    y = matmul(out.reshape(b, 1, h * hd), p["wo"])
    return y, cache

"""Plain PyTorch version of single-query decode attention.

Mirrors ``repro.kernels.decode_attention.ref.decode_attention_ref`` with
one change of interface: ``index`` is an int32 ``[B]`` tensor, one
position per batch row, where the reference takes one scalar and gets
per-row positions from ``jax.vmap``.  The CPU path of the wrapper and the
tests use it; ``chip_smoke.py`` holds the CUDA kernel against it.

``decode_attention_split_plain`` repeats the CUDA kernel's split-and-
combine arithmetic (per-chunk statistics, merged in chunk order) in plain
PyTorch, so the tests can hold that algorithm against the reference on
the CPU.  Only the tests use it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           index: torch.Tensor, *, window: int | None = None
                           ) -> torch.Tensor:
    """q: [B,1,H,D]; k,v: [B,L,KV,D]; index: int [B] -> [B,1,H,D].

    Row b attends to cache positions <= index[b] (and > index[b] - window
    when a window is set).
    """
    b, _, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, kv, group, d).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) / math.sqrt(d)
    kj = torch.arange(l, device=q.device)[None, :]
    pos = index.to(kj.dtype)[:, None]
    ok = kj <= pos
    if window is not None:
        ok &= kj > pos - window
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", probs, v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, index: torch.Tensor, *,
                                 chunk: int, window: int | None = None
                                 ) -> torch.Tensor:
    """``decode_attention_plain`` computed as the kernel computes it: each
    chunk of ``chunk`` cache rows gives its own float32 (m, l, acc), a
    chunk with nothing attended gives (NEG_INF, 0, -) and is left out, and
    out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).
    As in the kernel, an index past the cache is clamped to L-1, and a row
    that attends no row comes out 0."""
    b, _, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    group = h // kv
    n = -(-l // chunk)
    pad = (0, 0, 0, 0, 0, n * chunk - l)          # rows past L: masked
    kf, vf = (torch.nn.functional.pad(t.float(), pad) for t in (k, v))
    qg = q.reshape(b, kv, group, d).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg, kf) / math.sqrt(d)
    kj = torch.arange(n * chunk, device=q.device)[None, :]
    pos = index.to(kj.dtype)[:, None]
    ok = (kj <= pos) & (kj < l)
    if window is not None:
        ok &= kj > pos - window
    ok = ok.reshape(b, 1, 1, n, chunk)
    s = torch.where(ok, scores.reshape(b, kv, group, n, chunk), NEG_INF)
    m = s.amax(dim=-1)                                  # [b, kv, g, n]
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l_s = p.sum(dim=-1)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", p,
                       vf.reshape(b, n, chunk, kv, d))
    live = l_s > 0
    big = torch.where(live, m, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), 0.0)
    out = (w[..., None] * acc).sum(dim=-2) / \
        (w * l_s).sum(dim=-1).clamp(min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)

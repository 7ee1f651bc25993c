"""Plain PyTorch version of single-query decode attention.

Mirrors ``repro.kernels.decode_attention.ref.decode_attention_ref`` with
one change of interface: ``index`` is an int32 ``[B]`` tensor, one
position per batch row, where the reference takes one scalar and gets
per-row positions from ``jax.vmap``.  The CPU path of the wrapper and the
tests use it; ``chip_smoke.py`` holds the CUDA kernel against it.
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

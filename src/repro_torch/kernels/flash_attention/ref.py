"""Plain PyTorch version of blocked causal / sliding-window GQA attention.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: the scores
of every (query, key) pair in float32, masked to ``NEG_INF``, one softmax,
the output cast to q's dtype.  The wrapper's CPU tier and the tests use
it; ``chip_smoke.py`` holds the CUDA kernel against it on the card.

One deliberate difference: a query row that sees no key at all (a window
with L < S) comes out 0, as ``flash_attention_pallas`` and the reference's
``_sdpa_blocked`` give it (acc / max(l, 1e-30) with l = 0), where
``attention_ref``'s softmax over all-``NEG_INF`` scores averages v.  On
every other row the masked probabilities are exactly 0 either way.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,L,KV,D] (KV divides H) -> [B,S,H,D].

    Query row i attends key j when j <= i (``causal``) and j > i - window
    (a window is set); positions carry no offset when L != S.
    """
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, s, kv, group, d).float()
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k.float()) / math.sqrt(d)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(l, device=q.device)[None, :]
    ok = torch.ones((s, l), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * ok      # rows with no key -> 0
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)

"""Plain reference of held-out scoring: each batch's token-mean cross
entropy over its labels that are not -1, the forward in float32 with TF32
off (``transformer``), a few rows at a time."""

from __future__ import annotations

import torch

from perfbench.reference import transformer as plain


def batch_losses(mc: dict, params0: dict, batches: list[dict],
                 mm=torch.matmul, rows: int = 2) -> list[float]:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = _float32(params0)
        out = []
        with torch.no_grad():
            for b in batches:
                tok, lab = b["tokens"], b["labels"]
                total = count = 0.0
                for i in range(0, tok.shape[0], rows):
                    per_row = plain.row_losses(mc, params, tok[i:i + rows],
                                               lab[i:i + rows], mm)
                    real = (lab[i:i + rows] >= 0).sum(-1).double()
                    total += float((per_row.double() * real).sum())
                    count += float(real.sum())
                out.append(total / count)
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _float32(tree: dict) -> dict:
    return {k: _float32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}

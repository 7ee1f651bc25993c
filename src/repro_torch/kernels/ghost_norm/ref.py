"""Plain PyTorch oracle for the ghost-norm kernel.

Mirrors ``repro.kernels.ghost_norm.ref.ghost_norm_ref``: the full [B,S,S]
Gram matrices, in float32.  Opt-in only (``ghost_norm(...,
prefer_oracle=True)``); the wrapper's plain version on CPU tensors is the
blocked ``ops.ghost_norm_blocked``.
"""

from __future__ import annotations

import torch


def ghost_norm_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-example ||A_i^T G_i||_F^2 for a dense layer y = a @ W.

    a: [B, S, d_in] activations; g: [B, S, d_out] output cotangents.
    ||A^T G||_F^2 = sum_{s,t} (a_s . a_t)(g_s . g_t).  Returns [B] float32.
    """
    a32, g32 = a.float(), g.float()
    aa = torch.einsum("bsd,btd->bst", a32, a32)
    gg = torch.einsum("bsd,btd->bst", g32, g32)
    return torch.sum(aa * gg, dim=(1, 2))

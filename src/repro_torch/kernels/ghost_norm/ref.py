"""Plain PyTorch oracle for the ghost-norm kernel.

Mirrors ``repro.kernels.ghost_norm.ref.ghost_norm_ref``: the full [B,S,S]
Gram matrices, in float32.  Opt-in only (``ghost_norm(...,
prefer_oracle=True)``); the wrapper's plain version on CPU tensors is the
blocked ``ops.ghost_norm_blocked``.

``ghost_norm_tensor_core_plain`` repeats the CUDA kernel's tensor-core
arithmetic (bf16 products, or float32 split into TF32 terms, added in
float32 over the kernel's K-steps and chunks; 64 x 64 tiles of the upper
triangle) in plain PyTorch, so the tests can hold that arithmetic against
the reference on the CPU.  Only the tests use it.
"""

from __future__ import annotations

import torch

TILE = 64                  # kTile in csrc/ghost_norm.cu
K_STEP_BYTES = 32          # one mma.sync K-step: 16 bf16 or 8 float32
CHUNK_BYTES = 128          # kChunkBytes: 4 K-steps into one fresh sum


def ghost_norm_ref(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-example ||A_i^T G_i||_F^2 for a dense layer y = a @ W.

    a: [B, S, d_in] activations; g: [B, S, d_out] output cotangents.
    ||A^T G||_F^2 = sum_{s,t} (a_s . a_t)(g_s . g_t).  Returns [B] float32.
    """
    a32, g32 = a.float(), g.float()
    aa = torch.einsum("bsd,btd->bst", a32, a32)
    gg = torch.einsum("bsd,btd->bst", g32, g32)
    return torch.sum(aa * gg, dim=(1, 2))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 fraction bits, ties away from zero, kept as
    a float32 whose low 13 bits are zero.  Integer bit operations: adding
    half of the dropped unit to the magnitude and truncating rounds half
    away from zero in sign-magnitude."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _gram(x: torch.Tensor, tf32_terms: int) -> torch.Tensor:
    """x x^T per example as the kernel forms it: each 128-byte chunk of the
    feature axis (CHUNK_BYTES) summed into a fresh float32 sum, one K-step's
    products at a time, then added to the running float32 Gram; bf16
    products exact, float32 as ``tf32_terms`` TF32 products (3: lo*hi,
    hi*lo, hi*hi, each added on its own; 1: hi*hi)."""
    if x.dtype == torch.bfloat16:
        terms = [(x.float(), x.float())]
    elif tf32_terms == 3:
        hi = tf32_round(x)
        lo = tf32_round(x.float() - hi)
        terms = [(lo, hi), (hi, lo), (hi, hi)]
    elif tf32_terms == 1:
        hi = tf32_round(x)
        terms = [(hi, hi)]
    else:
        raise ValueError(f"tf32_terms is 1 or 3, got {tf32_terms}")
    b, s, d = x.shape
    step = K_STEP_BYTES // x.element_size()
    chunk = CHUNK_BYTES // x.element_size()
    acc = torch.zeros((b, s, s), dtype=torch.float32, device=x.device)
    for c0 in range(0, d, chunk):
        part = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + chunk, d), step):
            for u, v in terms:
                # one mma.sync: the step's products, exactly enough in
                # float64, rounded into the float32 sum
                blk = torch.bmm(u[..., k0:k0 + step].double(),
                                v[..., k0:k0 + step].double().transpose(1, 2))
                part = (part.double() + blk).float()
        acc = acc + part
    return acc


def ghost_norm_tensor_core_plain(a: torch.Tensor, g: torch.Tensor, *,
                                 tf32_terms: int = 3) -> torch.Tensor:
    """``ghost_norm_ref`` computed with the kernel's arithmetic: each Gram
    in its operand's dtype route (``_gram``), then per 64 x 64 tile of the
    upper triangle the float32 sum of aa * gg (twice for a tile off the
    diagonal), and each example's tile sums added in ascending pair
    order.  ``tf32_terms=1`` is the one-product TF32 variant the kernel
    does not use."""
    aa, gg = _gram(a, tf32_terms), _gram(g, tf32_terms)
    b, s, _ = a.shape
    out = torch.zeros((b,), dtype=torch.float32, device=a.device)
    for s0 in range(0, s, TILE):
        for t0 in range(s0, s, TILE):
            tile = (aa[:, s0:s0 + TILE, t0:t0 + TILE]
                    * gg[:, s0:s0 + TILE, t0:t0 + TILE]).sum(dim=(1, 2))
            out = out + (tile if s0 == t0 else 2 * tile)
    return out

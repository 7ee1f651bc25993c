"""Ghost norms: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

``ghost_norm(a, g)`` (a: [B,S,d_in], g: [B,S,d_out], each float32 or
bfloat16) returns the per-example ||A_b^T G_b||_F^2 as [B] float32.  It
validates its inputs, then

  * on CUDA tensors launches ``csrc/ghost_norm.cu`` (built at first use,
    see ``repro_torch.kernels._build``) on the current stream, or raises —
    there is no fallback to the plain version on the card;
  * on CPU tensors returns ``ghost_norm_blocked``, the kernel's algorithm
    in plain PyTorch (the reference's CPU tier), or the full-Gram oracle
    ``ghost_norm_ref`` when ``prefer_oracle`` is set; so it does on meta
    tensors, where a dry run traces shapes only.

``launches()`` counts kernel launches (never plain-version calls), so a
run can show that its dense-layer backwards went through the kernel.

DTensor inputs (the ``shard`` backend's model axis): the kernel (or the
plain version) runs on each rank's local shards, never on a local pointer
as if it held the global shape.  Where ``a`` or ``g`` is sharded on its
feature dim over a mesh dim, the local norms are summed over that mesh
dim (an all-reduce): ||A^T G||_F^2 is the sum over column blocks G_r of
||A^T G_r||^2, and likewise over row blocks of A.  Where both are, the
sum does not split and the wrapper raises; so it does for a sequence
split, whose cross terms (s, t) span ranks.  A batch split must be the
same on both and stays one on the norms.  A pending sum (a ``Partial``
operand) is all-reduced first.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, sm_count
from repro_torch.kernels.ghost_norm.ref import ghost_norm_ref

SOURCE = "ghost_norm"
TILE = 64                                        # kTile in the source
THREADS = 128                                    # kThreads in the source
CHUNK_BYTES = 128                                # kChunkBytes in the source
# split_plan: share a tile pair's chunks among blocks until the grid holds
# about BLOCKS_PER_SM blocks per SM, each block keeping MIN_CHUNKS chunks
BLOCKS_PER_SM = 4
MIN_CHUNKS = 16
MAX_SPLIT = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
_MAX_GRID_Y = 65535

_lock = threading.Lock()
_launches = 0  # guarded by _lock


def launches() -> int:
    """Kernel launches since the last ``reset_launches()``."""
    with _lock:
        return _launches


def reset_launches() -> None:
    global _launches
    with _lock:
        _launches = 0


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).ghost_norm_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, s: int, d_in: int, d_out: int, a_size: int,
               g_size: int, sms: int) -> int:
    """How many blocks share each tile pair's chunks of 128 bytes per row
    (a's, then g's) for a [b, s, d_in] of ``a_size``-byte elements and g
    [b, s, d_out] of ``g_size``-byte ones on a card of ``sms`` SMs: a power
    of two, doubled while the grid holds fewer than BLOCKS_PER_SM * sms
    blocks and every block keeps at least MIN_CHUNKS chunks.  Shapes and
    the card only."""
    n_tiles = -(-s // TILE)
    units = b * n_tiles * (n_tiles + 1) // 2
    chunks = -(-d_in * a_size // CHUNK_BYTES) + -(-d_out * g_size
                                                    // CHUNK_BYTES)
    split = 1
    while (split < MAX_SPLIT and units * split < BLOCKS_PER_SM * sms
           and chunks >= 2 * split * MIN_CHUNKS):
        split *= 2
    return split


def _query(fn_name: str, a_dtype: torch.dtype, g_dtype: torch.dtype) -> int:
    fn = getattr(_build.load(SOURCE), fn_name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    n = fn(_DTYPE_CODES[a_dtype], _DTYPE_CODES[g_dtype])
    if n < 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {-n}")
    return n


def smem_bytes(a_dtype: torch.dtype, g_dtype: torch.dtype) -> int:
    """The tile kernel's dynamic shared memory per block, in bytes, for a
    in ``a_dtype`` and g in ``g_dtype`` (builds the kernel if needed)."""
    return _query("ghost_norm_smem_bytes", a_dtype, g_dtype)


def blocks_per_sm(a_dtype: torch.dtype, g_dtype: torch.dtype) -> int:
    """Tile-kernel blocks that stay resident on one SM of the current card
    for a in ``a_dtype`` and g in ``g_dtype``."""
    return _query("ghost_norm_blocks_per_sm", a_dtype, g_dtype)


def ghost_norm_blocked(a: torch.Tensor, g: torch.Tensor,
                       block: int = 256) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: (s, t) tiles of ``block``
    rows, so the Gram working set is [B, block, block] instead of
    [B, S, S].  Counterpart of ``repro.kernels.ghost_norm.ops.
    ghost_norm_blocked``; a ragged last tile is a shorter slice where the
    reference pads with zero rows (which add nothing)."""
    b, s, _ = a.shape
    block = min(block, s)
    out = torch.zeros((b,), dtype=torch.float32, device=a.device)
    for s0 in range(0, s, block):
        a_s, g_s = a[:, s0:s0 + block].float(), g[:, s0:s0 + block].float()
        for t0 in range(0, s, block):
            a_t, g_t = a[:, t0:t0 + block].float(), g[:, t0:t0 + block].float()
            aa = torch.bmm(a_s, a_t.transpose(1, 2))
            gg = torch.bmm(g_s, g_t.transpose(1, 2))
            out = out + torch.sum(aa * gg, dim=(1, 2))
    return out


def _check(a: torch.Tensor, g: torch.Tensor) -> None:
    if a.dim() != 3 or g.dim() != 3 or a.shape[:2] != g.shape[:2]:
        raise ValueError(f"a and g must be [B,S,d_in] and [B,S,d_out], got "
                         f"{tuple(a.shape)} and {tuple(g.shape)}")
    if min(a.shape) < 1 or g.shape[2] < 1:
        raise ValueError(f"empty input: a {tuple(a.shape)}, g "
                         f"{tuple(g.shape)}")
    if a.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES:
        raise TypeError(f"a and g must each be float32 or bfloat16, got "
                        f"{a.dtype} and {g.dtype}")
    if a.device != g.device:
        raise ValueError(f"a and g must be on one device, got {a.device} "
                         f"and {g.device}")


def _check_kernel(a: torch.Tensor, g: torch.Tensor) -> None:
    if not (a.is_contiguous() and g.is_contiguous()):
        raise ValueError("the kernel needs contiguous a and g")
    b, s, _ = a.shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_Y} examples, "
                         f"got {b}")
    n_tiles = -(-s // TILE)
    if max(s, a.shape[2], g.shape[2], n_tiles * (n_tiles + 1) // 2) \
            > _INT32_MAX:
        raise ValueError("sequence length, widths and tile pairs must fit "
                         "int32")


def _is_dtensor(x) -> bool:
    return hasattr(x, "placements") and hasattr(x, "to_local")


def _ghost_norm_sharded(a, g, prefer_oracle: bool):
    """``ghost_norm`` of DTensor operands (a plain one is replicated): the
    local norms of the local shards, all-reduced over every mesh dim that
    splits a feature dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ref = a if _is_dtensor(a) else g
    mesh = ref.device_mesh
    # a pending sum (a Partial cotangent) is reduced first: the norm is
    # not linear in its operands
    a, g = (x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
            if _is_dtensor(x) and any(p.is_partial() for p in x.placements)
            else x for x in (a, g))
    none = [Replicate()] * mesh.ndim
    pa = list(a.placements) if _is_dtensor(a) else none
    pg = list(g.placements) if _is_dtensor(g) else none
    out = []
    for md, (qa, qg) in enumerate(zip(pa, pg)):
        feat_a = isinstance(qa, Shard) and qa.dim == 2
        feat_g = isinstance(qg, Shard) and qg.dim == 2
        if feat_a and feat_g:
            raise ValueError(
                f"ghost_norm: a and g are both sharded on their feature dims "
                f"over mesh dim {md}; ||A^T G||^2 does not split into "
                f"per-rank sums there (gather one of them first)")
        if qa == qg and (qa.is_replicate() or qa == Shard(0)):
            out.append(qa)
        elif (feat_a and qg.is_replicate()) or (feat_g and qa.is_replicate()):
            out.append(Partial())
        else:
            raise ValueError(f"ghost_norm: placements {qa} of a and {qg} of "
                             f"g over mesh dim {md} do not split the norm")
    la = a.to_local() if _is_dtensor(a) else a
    lg = g.to_local() if _is_dtensor(g) else g
    local = ghost_norm(la.contiguous(), lg.contiguous(),
                       prefer_oracle=prefer_oracle)
    norms = DTensor.from_local(local, mesh, out, run_check=False)
    if any(p.is_partial() for p in out):
        norms = norms.redistribute(
            mesh, [Replicate() if p.is_partial() else p for p in out])
    return norms


def ghost_norm(a: torch.Tensor, g: torch.Tensor, *,
               prefer_oracle: bool = False) -> torch.Tensor:
    """a: [B,S,d_in]; g: [B,S,d_out] -> [B] float32 ghost norms^2."""
    if _is_dtensor(a) or _is_dtensor(g):
        return _ghost_norm_sharded(a, g, prefer_oracle)
    _check(a, g)
    if a.device.type in ("cpu", "meta"):
        return ghost_norm_ref(a, g) if prefer_oracle else \
            ghost_norm_blocked(a, g)
    if a.device.type != "cuda":
        raise ValueError(f"ghost_norm runs on cuda or cpu tensors, got "
                         f"{a.device}")
    _check_kernel(a, g)
    b, s, d_in = a.shape
    n_tiles = -(-s // TILE)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    split = split_plan(b, s, d_in, g.shape[2], a.element_size(),
                       g.element_size(), sm_count(a.device))
    partial = torch.empty((b, n_pairs), dtype=torch.float32, device=a.device)
    # each block's two partial Grams where blocks share a tile pair
    scratch = torch.empty((b, n_pairs, split, 2, 32, THREADS)
                          if split > 1 else (0,),
                          dtype=torch.float32, device=a.device)
    out = torch.empty((b,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _launcher()(
            a.data_ptr(), g.data_ptr(), partial.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, s, d_in, g.shape[2],
            _DTYPE_CODES[a.dtype], _DTYPE_CODES[g.dtype], split,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ghost_norm kernel launch failed with CUDA "
                           f"error {err}")
    global _launches
    with _lock:
        _launches += 1
    return out

"""Flash attention: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

``flash_attention(q, k, v)`` (q: [B,S,H,D]; k, v: [B,L,KV,D]) validates
its inputs against the reference's contract, then

  * on CUDA tensors launches ``csrc/flash_attention.cu`` (built at first
    use, see ``repro_torch.kernels._build``) on the current stream, or
    raises — there is no fallback to the plain version on the card;
  * on CPU tensors returns ``attention_plain``.

The source holds two kernels and the launcher picks one by dtype:
bfloat16 runs on the tensor cores (``mma.sync``), float32 on the CUDA
cores (tensor cores would mean TF32, too coarse for the float32 limit).
That is a dispatch between two hand-written kernels, not a fallback.

The reference defines no backward for its kernel, and neither does the
port: on CUDA tensors the wrapper raises when grad mode is on and an input
requires grad, rather than return a result autograd would differentiate
wrongly.  ``launches()`` counts kernel launches (never plain-version
calls), so a run can show that its attention went through the kernel;
``launches(variant)`` counts those of one kernel (``VARIANTS``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_plain

SOURCE = "flash_attention"
HEAD_DIMS = (32, 64, 128, 192, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches: CUDA cores for float32, tensor cores for
# bfloat16
VARIANTS = {torch.float32: "simt_fp32", torch.bfloat16: "mma_bf16"}
_INT32_MAX = 2**31 - 1
_MAX_GRID_YZ = 65535
_QUERY_TILE = 64   # query rows per block, in either kernel

_lock = threading.Lock()
_launches = dict.fromkeys(VARIANTS.values(), 0)  # guarded by _lock


def launches(variant: str | None = None) -> int:
    """Kernel launches since the last ``reset_launches()``: all of them, or
    those of one of ``VARIANTS``' kernels."""
    with _lock:
        return sum(_launches.values()) if variant is None else \
            _launches[variant]


def reset_launches() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, block_q, block_k) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B,S,H,D], got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"k and v must be one [B,L,KV,D] shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or min(b, s, l, kv) < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit k and v "
                         f"{tuple(k.shape)}")
    if h % kv:
        raise ValueError(f"{h} query heads do not divide into {kv} KV heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    # the reference's contract (flash_attention_pallas asserts it)
    bq, bk = min(block_q, s), min(block_k, l)
    if bq < 1 or bk < 1 or s % bq or l % bk:
        raise ValueError(f"pad seq to block multiple: S={s} with block_q="
                         f"{block_q}, L={l} with block_k={block_k}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must be on one device")


def _check_kernel(q, k, v) -> None:
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("the kernel needs contiguous q, k and v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel copies q, k and v in 16-byte pieces "
                         "and needs them 16-byte aligned")
    tiles = -(-s // _QUERY_TILE)
    if max(s, k.shape[1]) > _INT32_MAX or max(b, h, tiles) > _MAX_GRID_YZ:
        raise ValueError("sequence lengths must fit int32; batch, heads and "
                         f"query tiles at most {_MAX_GRID_YZ}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (the reference defines none "
            "for its kernel): call it under torch.no_grad(), or train "
            "through models.attention._sdpa_blocked")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,S,H,D]; k,v: [B,L,KV,D] -> [B,S,H,D] in q's dtype.

    Query row i attends key j when j <= i (``causal``) and j > i - window
    (a window is set); query head h reads KV head h // (H // KV).  As in
    the reference, S must be a multiple of min(block_q, S) and L of
    min(block_k, L).  ``block_q`` and ``block_k`` only decide which
    inputs are refused: the kernels' own tiles (64 query rows by 64 keys
    in bfloat16, 32 keys above head_dim 128; 64 query rows by 32 keys in
    float32, 32 rows above 128) mask the ragged edges, whatever they are.
    """
    _check(q, k, v, window, block_q, block_k)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_kernel(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], h, k.shape[2], d, int(causal),
            # a window of S or more masks no key (i - window < 0 on every row)
            0 if window is None else min(window, s), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with "
                           f"CUDA error {err}")
    with _lock:
        _launches[VARIANTS[q.dtype]] += 1
    return out

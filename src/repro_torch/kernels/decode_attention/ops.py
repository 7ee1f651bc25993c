"""Decode attention: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

``decode_attention`` validates its inputs, then

  * on CUDA tensors launches ``csrc/decode_attention.cu`` (built at first
    use, see ``repro_torch.kernels._build``) on the current stream, or
    raises — there is no fallback to the plain version on the card;
  * on CPU tensors returns ``decode_attention_plain``.

On the card one call is two CUDA kernels: a split kernel over chunks of
the cache (``split_plan``: from the shapes and the card's SM count alone,
never from ``index``) writing float32 statistics into scratch this wrapper
allocates, and a combine kernel that merges them in a fixed order.
``decode_attention_split_plain`` repeats that arithmetic in plain PyTorch
for the tests.

``launches()`` counts calls of the wrapper that reached the kernels, one
per attention (not CUDA launches, and never plain-version calls), so a run
can show that its decode path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build, sm_count
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

SOURCE = "decode_attention"
HEAD_DIMS = (32, 64, 128, 192, 256)
MAX_GROUP = 16                                   # kMaxGroup in the source
SPLIT_ROWS = 64           # a chunk is a multiple of this many cache rows
BLOCKS_PER_SM = 4         # split blocks to aim for, per SM of the card
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1

_lock = threading.Lock()
_launches = 0  # guarded by _lock


def launches() -> int:
    """Calls that launched the kernels since the last ``reset_launches()``."""
    with _lock:
        return _launches


def reset_launches() -> None:
    global _launches
    with _lock:
        _launches = 0


@functools.cache
def _launcher():
    fn = _build.load(SOURCE).decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, l: int, kv: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): how the kernel cuts a cache of ``l`` rows for ``b``
    batch rows of ``kv`` KV heads on a card of ``sms`` SMs.  Enough splits for about ``BLOCKS_PER_SM * sms`` blocks, each
    of at least ``SPLIT_ROWS`` rows; the chunk is a multiple of
    ``SPLIT_ROWS`` and the last split may be short.  Shapes and the card
    only: the values of ``index`` never change the plan."""
    target = BLOCKS_PER_SM * sms
    n = max(1, min(-(-l // SPLIT_ROWS), -(-target // (b * kv))))
    rows = -(-l // n)                                  # ceil(l / n)
    chunk = -(-rows // SPLIT_ROWS) * SPLIT_ROWS
    return -(-l // chunk), chunk


def _check(q, k, v, index, window) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B,1,H,D], got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"k and v must be one [B,L,KV,D] shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 or b < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not divide into "
                         f"{k.shape[2]} KV heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if index.dtype != torch.int32 or tuple(index.shape) != (b,):
        raise TypeError(f"index must be int32 [{b}], got {index.dtype} "
                        f"{tuple(index.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if len({t.device for t in (q, k, v, index)}) != 1:
        raise ValueError("q, k, v and index must be on one device")


def _check_kernel(q, k, v, index) -> None:
    b, _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if h // k.shape[2] > MAX_GROUP:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads "
                         f"per KV head, got {h // k.shape[2]}")
    if not all(t.is_contiguous() for t in (q, k, v, index)):
        raise ValueError("the kernel needs contiguous q, k, v and index")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel loads k and v as 16-byte vectors and "
                         "needs them 16-byte aligned")
    if max(b * k.shape[2], k.shape[1]) > _INT32_MAX:
        raise ValueError("batch x KV heads and cache length must fit int32")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     index: torch.Tensor, *, window: int | None = None
                     ) -> torch.Tensor:
    """q: [B,1,H,D]; k,v: [B,L,KV,D]; index: int32 [B] -> [B,1,H,D].

    Row b attends to cache rows <= index[b], and > index[b] - window when
    a window is set; query head h reads KV head h // (H // KV).  An index
    past the cache is clamped to L-1 by the kernel (the engine never asks
    for one).
    """
    _check(q, k, v, index, window)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, index, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_kernel(q, k, v, index)
    b, _, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    n_splits, chunk = split_plan(b, l, kv, sm_count(q.device))
    out = torch.empty_like(q)
    # per split and query head: acc [D], then (m, l), all float32
    scratch = torch.empty(b * h * n_splits * (d + 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), index.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, l, h, kv, d,
            0 if window is None else window, chunk, _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with "
                           f"CUDA error {err}")
    global _launches
    with _lock:
        _launches += 1   # one call, two CUDA kernels
    return out

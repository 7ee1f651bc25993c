"""Pytree checkpoints in the ``repro-ckpt-v1`` format, without JAX or msgpack.

Counterpart of ``repro.checkpoint.checkpoint``, byte for byte: for the same
tree, step and metadata both packages write the same file, and each loads
the other's.  A tree is nested dicts, lists and tuples whose leaves are
torch tensors (on any device), numpy arrays or Python scalars.  Each leaf
is stored as ``{"__arr__": True, "dtype", "shape", "data"}`` with the
numpy dtype name (``"bfloat16"`` for ``torch.bfloat16``) and its C-order
bytes; dicts as ``{"__map__": ...}`` with their keys sorted, as the
reference's ``jax.device_get`` leaves them; lists and tuples as
``{"__seq__": [...], "__tuple__": bool}``.  The payload is
``{"format": "repro-ckpt-v1", "step", "metadata", "tree"}``, encoded by the
port's own msgpack subset (``_msgpack``).

Leaves are copied to the host one at a time while the file is written,
straight into it.  The write is atomic: a temp file in the target
directory, renamed over ``path`` when complete and removed on any failure,
so a reader never observes a half-written checkpoint under the final name.

``load_checkpoint`` returns CPU tensors in the file's dtypes (bfloat16
included, read through int16 without numpy's help).  A truncated, torn or
foreign file raises ``CorruptCheckpointError``; ``FileNotFoundError``
passes through, so a watcher can tell "not there yet" from "there but
broken".
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

PyTree = Any

_ARR = "__arr__"

# stamped into every payload; load rejects files that carry another stamp
# (pre-format files, without one, still load)
_FORMAT = "repro-ckpt-v1"


class CorruptCheckpointError(RuntimeError):
    """The file is not a complete, well-formed checkpoint."""


class _Leaf:
    """A tree leaf, turned into its ``__arr__`` record only when the
    encoder reaches it (so one leaf at a time is on the host)."""

    __slots__ = ("value",)

    def __init__(self, value) -> None:
        self.value = value

    def record(self) -> dict:
        x = self.value
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                arr, dtype = t.view(torch.int16).numpy(), "bfloat16"
            else:
                arr = t.numpy()
                dtype = str(arr.dtype)
        else:
            arr = np.asarray(x)
            dtype = str(arr.dtype)
        data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        return {_ARR: True, "dtype": dtype, "shape": list(arr.shape),
                "data": memoryview(data)}


def _record(obj) -> dict:
    # the encoder's hook for what msgpack cannot hold: tree leaves only
    if isinstance(obj, _Leaf):
        return obj.record()
    raise TypeError(f"cannot pack {type(obj).__name__} into a checkpoint")


def _pack(tree):
    if isinstance(tree, dict):
        return {"__map__": {k: _pack(tree[k]) for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": [_pack(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    return _Leaf(tree)


def _tensor(data, dtype: str, shape) -> torch.Tensor:
    """One leaf's CPU tensor from its bytes: one copy, the file's dtype."""
    np_dtype = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _unpack(obj):
    if isinstance(obj, dict) and "__map__" in obj:
        return {k: _unpack(v) for k, v in obj["__map__"].items()}
    if isinstance(obj, dict) and "__seq__" in obj:
        seq = [_unpack(v) for v in obj["__seq__"]]
        return tuple(seq) if obj.get("__tuple__") else seq
    if isinstance(obj, dict) and obj.get(_ARR):
        return _tensor(obj["data"], obj["dtype"], obj["shape"])
    return obj


def _owned(obj):
    """``obj`` with every ``bin`` view of the file turned into ``bytes``, so
    the metadata returned does not hold the whole file's buffer alive."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, list):
        return [_owned(v) for v in obj]
    if isinstance(obj, dict):
        return {_owned(k): _owned(v) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, tree: PyTree, step: int = 0,
                    metadata: dict | None = None) -> None:
    payload = {
        "format": _FORMAT,
        "step": step,
        "metadata": metadata or {},
        "tree": _pack(tree),
    }
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            _msgpack.pack(payload, f.write, default=_record)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> tuple[PyTree, int, dict]:
    """Load ``path`` -> (tree, step, metadata); leaves are CPU tensors.

    Raises ``CorruptCheckpointError`` on truncated, torn or non-checkpoint
    files (msgpack decode failures, missing payload keys, a foreign format
    stamp, or array bytes that do not match their declared dtype/shape);
    ``FileNotFoundError`` passes through untouched.
    """
    with open(path, "rb") as f:
        raw = f.read()
    try:
        payload = _msgpack.unpackb(raw)
    except Exception as e:
        raise CorruptCheckpointError(
            f"{path}: not a complete msgpack document ({e})"
        ) from e
    if not isinstance(payload, dict) or "tree" not in payload \
            or "step" not in payload:
        raise CorruptCheckpointError(
            f"{path}: msgpack document is not a checkpoint payload"
        )
    fmt = payload.get("format", _FORMAT)  # pre-format files pass
    if fmt != _FORMAT:
        raise CorruptCheckpointError(
            f"{path}: unsupported checkpoint format {fmt!r}"
        )
    try:
        tree = _unpack(payload["tree"])
    except Exception as e:
        raise CorruptCheckpointError(
            f"{path}: array payload does not match its declared "
            f"dtype/shape ({e})"
        ) from e
    return tree, payload["step"], _owned(payload.get("metadata", {}))

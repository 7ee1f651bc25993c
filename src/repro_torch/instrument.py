"""Program-call accounting for the serving hot path.

Counterpart of ``repro.instrument``.  The reference counts launches of
jitted programs; the port runs eagerly (no jit, no CUDA graph yet), so
``instrumented(fn)`` counts calls of the functions that stand for those
programs: the engine's decode step, prefill and cache insert.  The API is
the reference's — ``jit_dispatches()`` and ``reset_jit_dispatches()`` —
so the structural contract reads the same in both packages: one call per
steady-state decode step, two per admission, none per eviction.

The counter increments under a lock (an unguarded ``+= 1`` loses ticks
when two threads dispatch at once).  With ``repro_torch.obs`` recording
on, each call also records a ``jit_dispatch`` span and a
``jit_dispatches`` counter event, as the reference does.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable

import repro_torch.obs as obs

_count_lock = threading.Lock()
_jit_dispatch_count = 0  # guarded by _count_lock


def instrumented(fn: Callable) -> Callable:
    """``fn`` with every call counted (``jit_dispatches()``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _jit_dispatch_count
        with _count_lock:
            _jit_dispatch_count += 1
        t0 = obs.now()  # None when recording is off
        out = fn(*args, **kwargs)
        if t0 is not None:
            obs.complete("jit_dispatch", t0, cat="jit",
                         fn=getattr(fn, "__name__", "<fn>"))
            obs.counter("jit_dispatches", 1)
        return out

    return wrapper


def jit_dispatches() -> int:
    """Total instrumented program calls since the last reset."""
    with _count_lock:
        return _jit_dispatch_count


def reset_jit_dispatches() -> None:
    global _jit_dispatch_count
    with _count_lock:
        _jit_dispatch_count = 0

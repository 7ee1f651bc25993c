"""repro_torch.obs — the port's tracing switch and recording API.

The port's own copy of ``repro.obs`` (the ``jax.profiler`` bridge is left
out).  Recording is OFF by default, and a disabled recorder is a
structural no-op: ``span()`` returns a shared ``nullcontext`` and
``counter()`` / ``ledger_round()`` return at once, so nothing on the hot
path syncs the device or adds work.  A recorder given a device clock
(``obs.device.CudaClock``) also times the spans opened with
``device_time=True`` on the device, without a sync until export.

    import repro_torch.obs as obs

    with obs.recording() as rec:
        ...                                      # serve, train, ...
        obs.export("obs_out")                    # events + ledger + trace

Artifacts (``obs.export(dir)``): ``events.jsonl``, the raw event stream
(schema in ``recorder.py``); ``ledger.jsonl``, the hash-chained privacy
ledger (schema in ``ledger.py``); and ``trace.json``, the Chrome-trace /
Perfetto conversion of the events.
"""

from __future__ import annotations

import contextlib
import os
import threading
from pathlib import Path
from typing import Any, Iterable, Iterator

from repro_torch.obs.convert import chrome_trace, write_chrome_trace
from repro_torch.obs.ledger import (
    LedgerError,
    PrivacyLedger,
    per_hospital_epsilon,
    read_entries,
    validate_entries,
)
from repro_torch.obs.recorder import (
    EventStreamError,
    Recorder,
    read_events,
    validate_events,
)

_LOCK = threading.Lock()
_RECORDER: Recorder | None = None

# One shared no-op context for the disabled path: span() must cost a global
# read and a return, nothing more.
_NULL = contextlib.nullcontext()


# -- process-wide switch -------------------------------------------------------


def recorder() -> Recorder | None:
    """The active process-wide recorder, or None when recording is off."""
    return _RECORDER


def enable(rec: Recorder | None = None) -> Recorder:
    """Install ``rec`` (or a fresh ``Recorder``) process-wide."""
    global _RECORDER
    with _LOCK:
        if rec is None:
            rec = Recorder()
        _RECORDER = rec
    return rec


def disable() -> Recorder | None:
    """Uninstall and return the active recorder (None if none was)."""
    global _RECORDER
    with _LOCK:
        rec, _RECORDER = _RECORDER, None
    return rec


@contextlib.contextmanager
def recording(rec: Recorder | None = None) -> Iterator[Recorder]:
    """Scoped recording: installs a recorder, restores the previous one on
    exit (so tests and nested tools cannot leak global state)."""
    global _RECORDER
    with _LOCK:
        prev = _RECORDER
    rec = enable(rec)
    try:
        yield rec
    finally:
        with _LOCK:
            _RECORDER = prev


# -- recording API (no-ops when disabled) --------------------------------------


def span(name: str, *, cat: str = "obs", device_time: bool = False,
         **args: Any):
    """Nestable timed region; a shared no-op context when recording is off.
    ``device_time``: also timed on the device when the recorder has a
    device clock (``Recorder``)."""
    rec = _RECORDER
    return (rec.span(name, cat=cat, device_time=device_time, **args)
            if rec is not None else _NULL)


def now() -> float | None:
    """Span start timestamp for the ``complete()`` spelling; None = off."""
    rec = _RECORDER
    return rec.now() if rec is not None else None


def complete(name: str, t_start: float | None, *, cat: str = "obs",
             **args: Any) -> None:
    """Close a span opened with ``now()``; no-op when recording is off (or
    when ``t_start`` was taken while it was off)."""
    rec = _RECORDER
    if rec is not None and t_start is not None:
        rec.complete(name, t_start, cat=cat, **args)


def counter(name: str, inc: float = 1.0, **args: Any) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.counter(name, inc, **args)


def ledger_round(arm: Any, *, round: int, backend: str,
                 cohort: Iterable[int], delivered: Iterable[int],
                 bytes_up: float, topup: bool = False) -> None:
    """Append one accounted round to the privacy ledger (one entry per
    hospital).  ``arm`` is duck-typed (``name``, ``h``, ``cfg``,
    ``epsilon()``).  Call AFTER ``arm.account()``: the ledger records the
    post-round cumulative ε."""
    rec = _RECORDER
    if rec is None:
        return
    cfg = arm.cfg
    rec.ledger.record_round(
        round=round, arm=arm.name, backend=backend, hospitals=arm.h,
        cohort=cohort, delivered=delivered,
        epsilon=arm.epsilon(), delta=cfg.dp.delta,
        sampling_rate=getattr(arm, "rate", 0.0),
        participation_rate=cfg.participation_rate,
        noise_multiplier=cfg.dp.noise_multiplier,
        bytes_up=bytes_up, topup=topup,
    )


# -- artifact export -----------------------------------------------------------

EVENTS_FILE = "events.jsonl"
LEDGER_FILE = "ledger.jsonl"
TRACE_FILE = "trace.json"


def export(out_dir: str | os.PathLike,
           rec: Recorder | None = None) -> dict[str, Path]:
    """Write events.jsonl + ledger.jsonl + trace.json into ``out_dir``.

    Uses the active recorder when ``rec`` is not given; raises if neither
    exists (exporting nothing silently would hide a lost trace).  Spans
    timed on the device are resolved first (a wait for the device).
    """
    rec = rec if rec is not None else _RECORDER
    if rec is None:
        raise RuntimeError("obs.export: recording is not enabled and no "
                           "recorder was passed")
    rec.resolve_device_times()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = {"events": out / EVENTS_FILE, "ledger": out / LEDGER_FILE,
             "trace": out / TRACE_FILE}
    rec.write_jsonl(paths["events"])
    rec.ledger.write_jsonl(paths["ledger"])
    write_chrome_trace(rec.events(), paths["trace"])
    return paths


__all__ = [
    "EventStreamError",
    "LedgerError",
    "PrivacyLedger",
    "Recorder",
    "chrome_trace",
    "complete",
    "counter",
    "disable",
    "enable",
    "export",
    "ledger_round",
    "now",
    "per_hospital_epsilon",
    "read_entries",
    "read_events",
    "recorder",
    "recording",
    "span",
    "validate_entries",
    "validate_events",
    "write_chrome_trace",
]

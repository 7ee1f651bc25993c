"""The structured tracing core: spans, counters, gauges, one Recorder.

The port's own copy of ``repro.obs.recorder`` (stdlib only), without the
``jax.profiler`` bridge.  The privacy ledger rides the recorder, as in the
reference, so one ``enable()`` turns on spans and the ledger together.

A ``Recorder`` is a process-wide, **thread-safe** event buffer.  Three
typed event kinds, all host-side timestamps only (``time.perf_counter``
relative to the recorder's epoch — recording never forces a device sync):

  * **span**  — a named duration with thread id and nesting ``depth``
    (per-thread stack), recorded as ONE complete event at exit;
  * **counter** — a monotonically accumulated metric; each increment
    records the post-increment ``total`` so the export is a time series;
  * **gauge** — a sampled instantaneous value.

Spans come in two spellings with identical output: the ``span()`` context
manager, and ``now()`` + ``complete()`` for loop bodies.

The event schema (the JSONL export, one object per line — the reference's,
DESIGN.md §11):

    {"type": "meta", "schema": 1, "pid": ..., "epoch": ...}       # line 1
    {"type": "span", "name", "cat", "ts", "dur", "tid", "depth", "args"}
    {"type": "counter", "name", "ts", "inc", "total", "tid", "args"}
    {"type": "gauge", "name", "ts", "value", "tid", "args"}

``ts``/``dur`` are float seconds since the recorder epoch.  Events append
under one lock in completion order, so a reader never sees a half-written
record; ``ts`` across threads is not monotone in file order.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Iterator, Mapping, Sequence

SCHEMA_VERSION = 1

EVENT_TYPES = ("meta", "span", "counter", "gauge")


class Recorder:
    """Thread-safe, process-wide buffer of spans / counters / gauges."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self._epoch = clock()
        self._events: list[dict] = []
        self._counters: dict[str, float] = {}
        self._tls = threading.local()     # per-thread span stack (depth)
        from repro_torch.obs.ledger import PrivacyLedger

        self.ledger = PrivacyLedger()

    def now(self) -> float:
        """Seconds since the recorder's epoch (host clock, no device sync)."""
        return self._clock() - self._epoch

    # -- spans ----------------------------------------------------------------

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "obs",
             **args: Any) -> Iterator[None]:
        """Nestable timed region; one complete event is recorded at exit."""
        depth = self._depth()
        self._tls.depth = depth + 1
        t0 = self.now()
        try:
            yield
        finally:
            t1 = self.now()
            self._tls.depth = depth
            self._emit({
                "type": "span", "name": name, "cat": cat,
                "ts": t0, "dur": t1 - t0,
                "tid": threading.get_ident(), "depth": depth,
                "args": args,
            })

    def complete(self, name: str, t_start: float, *, cat: str = "obs",
                 **args: Any) -> None:
        """Record a span that started at ``t_start`` (from ``now()``) and
        ends now — the non-context-manager spelling for loop bodies."""
        t1 = self.now()
        self._emit({
            "type": "span", "name": name, "cat": cat,
            "ts": t_start, "dur": t1 - t_start,
            "tid": threading.get_ident(), "depth": self._depth(),
            "args": args,
        })

    # -- counters / gauges ----------------------------------------------------

    def counter(self, name: str, inc: float = 1.0, **args: Any) -> float:
        """Accumulate ``inc`` onto counter ``name``; returns the new total."""
        ts = self.now()
        with self._lock:
            total = self._counters.get(name, 0.0) + inc
            self._counters[name] = total
            self._events.append({
                "type": "counter", "name": name, "ts": ts,
                "inc": inc, "total": total,
                "tid": threading.get_ident(), "args": args,
            })
        return total

    def gauge(self, name: str, value: float, **args: Any) -> None:
        self._emit({
            "type": "gauge", "name": name, "ts": self.now(),
            "value": value, "tid": threading.get_ident(), "args": args,
        })

    # -- reads ----------------------------------------------------------------

    def _emit(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def events(self) -> list[dict]:
        """Snapshot of all recorded events (completion order)."""
        with self._lock:
            return list(self._events)

    def counter_totals(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def span_totals(self) -> dict[str, tuple[int, float]]:
        """name -> (count, total seconds) over recorded spans."""
        out: dict[str, tuple[int, float]] = {}
        for ev in self.events():
            if ev["type"] != "span":
                continue
            n, s = out.get(ev["name"], (0, 0.0))
            out[ev["name"]] = (n + 1, s + ev["dur"])
        return out

    # -- export ---------------------------------------------------------------

    def meta(self) -> dict:
        return {"type": "meta", "schema": SCHEMA_VERSION,
                "pid": os.getpid(), "epoch": self._epoch}

    def to_jsonl(self) -> str:
        lines = [json.dumps(self.meta(), sort_keys=True)]
        lines += [json.dumps(ev, sort_keys=True) for ev in self.events()]
        return "\n".join(lines) + "\n"

    def write_jsonl(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())


# -- stream readers / validation ----------------------------------------------


class EventStreamError(ValueError):
    """A JSONL event stream failed structural validation."""


def read_events(path: str | os.PathLike) -> list[dict]:
    """Parse a JSONL event file (including the leading meta line)."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise EventStreamError(f"line {lineno}: not JSON: {e}") from e
    return events


_REQUIRED: Mapping[str, tuple[str, ...]] = {
    "meta": ("schema", "pid"),
    "span": ("name", "ts", "dur", "tid", "depth", "args"),
    "counter": ("name", "ts", "inc", "total", "tid"),
    "gauge": ("name", "ts", "value", "tid"),
}


def validate_events(events: Sequence[Mapping]) -> dict:
    """Structural validation of an event stream; returns a summary dict.

    Checks: known event types, required fields, non-negative durations and
    depths, per-name counter totals consistent with the per-event
    increments.  Raises ``EventStreamError`` on the first violation.
    """
    totals: dict[str, float] = {}
    n_by_type: dict[str, int] = {}
    for i, ev in enumerate(events):
        etype = ev.get("type")
        if etype not in EVENT_TYPES:
            raise EventStreamError(f"event {i}: unknown type {etype!r}")
        missing = [k for k in _REQUIRED[etype] if k not in ev]
        if missing:
            raise EventStreamError(
                f"event {i} ({etype}): missing fields {missing}")
        n_by_type[etype] = n_by_type.get(etype, 0) + 1
        if etype == "span":
            if ev["dur"] < 0:
                raise EventStreamError(
                    f"event {i}: span {ev['name']!r} has negative duration")
            if ev["depth"] < 0:
                raise EventStreamError(
                    f"event {i}: span {ev['name']!r} has negative depth")
        elif etype == "counter":
            # increments happen under the recorder lock in file order, so
            # each name's totals chain across threads too
            expect = totals.get(ev["name"], 0.0) + ev["inc"]
            if abs(expect - ev["total"]) > 1e-9 * max(1.0, abs(expect)):
                raise EventStreamError(
                    f"event {i}: counter {ev['name']!r} total {ev['total']} "
                    f"does not chain from running sum {expect}")
            totals[ev["name"]] = ev["total"]
    return {"events": len(events), "by_type": n_by_type,
            "counter_totals": totals}

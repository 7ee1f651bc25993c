"""The structured tracing core: spans, counters, one Recorder.

The port's own copy of ``repro.obs.recorder`` (stdlib only), without the
``jax.profiler`` bridge.  The privacy ledger rides the recorder, as in the
reference, so one ``enable()`` turns on spans and the ledger together.

A ``Recorder`` is a process-wide, **thread-safe** event buffer.  It records
two typed event kinds, with host-side timestamps (``time.perf_counter``
relative to the recorder's epoch — recording never forces a device sync):

  * **span**  — a named duration with thread id and nesting ``depth``
    (per-thread stack), recorded as ONE complete event at exit;
  * **counter** — a monotonically accumulated metric; each increment
    records the post-increment ``total`` so the export is a time series.

The reference also records **gauges** (a sampled instantaneous value);
nothing in the port samples one, but ``validate_events`` and the converter
read them in the reference's exports.

Spans come in two spellings with identical output: the ``span()`` context
manager, and ``now()`` + ``complete()`` for loop bodies.

Device time: a recorder given a ``device_clock`` (``obs.device.CudaClock``,
or any object with ``epoch``, ``mark()``, ``seconds(a, b)`` and
``synchronize()``) marks the device's stream at entry and exit of every
span opened with ``device_time=True``.  Nothing waits for the marks while
the program runs; ``resolve_device_times()``, called once the work is done
(``obs.export`` calls it), waits for the device and gives each such span
``dev_ts`` and ``dev_dur``: float seconds since the clock's epoch on the
device's own clock.  Without a device clock ``device_time`` does nothing.

The event schema (the JSONL export, one object per line — the reference's,
DESIGN.md §11):

    {"type": "meta", "schema": 1, "pid": ..., "epoch": ...}       # line 1
    {"type": "span", "name", "cat", "ts", "dur", "tid", "depth", "args"}
                                     # + "dev_ts", "dev_dur" when resolved
    {"type": "counter", "name", "ts", "inc", "total", "tid", "args"}
    {"type": "gauge", "name", "ts", "value", "tid", "args"}  # reference's

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
    """Thread-safe, process-wide buffer of spans and counters.

    ``device_clock`` (see the module docstring) times the spans opened with
    ``device_time=True`` on the device too; it may also be set on the
    attribute before those spans open."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 device_clock: Any = None) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self._epoch = clock()
        self._events: list[dict] = []
        self._counters: dict[str, float] = {}
        self._tls = threading.local()     # per-thread span stack (depth)
        self.device_clock = device_clock
        # (span event, entry mark, exit mark) awaiting resolve_device_times
        self._device_marks: list[tuple[dict, Any, Any]] = []
        from repro_torch.obs.ledger import PrivacyLedger

        self.ledger = PrivacyLedger()

    def now(self) -> float:
        """Seconds since the recorder's epoch (host clock, no device sync)."""
        return self._clock() - self._epoch

    # -- spans ----------------------------------------------------------------

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "obs", device_time: bool = False,
             **args: Any) -> Iterator[None]:
        """Nestable timed region; one complete event is recorded at exit.
        With ``device_time`` and a device clock, the device's stream is
        marked at entry and exit too (never waited for here)."""
        clock = self.device_clock if device_time else None
        depth = self._depth()
        self._tls.depth = depth + 1
        d0 = clock.mark() if clock is not None else None
        t0 = self.now()
        try:
            yield
        finally:
            t1 = self.now()
            d1 = clock.mark() if clock is not None else None
            self._tls.depth = depth
            event = {
                "type": "span", "name": name, "cat": cat,
                "ts": t0, "dur": t1 - t0,
                "tid": threading.get_ident(), "depth": depth,
                "args": args,
            }
            with self._lock:
                self._events.append(event)
                if clock is not None:
                    self._device_marks.append((event, d0, d1))

    def resolve_device_times(self) -> int:
        """Wait for the device, then give every device-timed span recorded
        so far its ``dev_ts`` and ``dev_dur`` (seconds since the device
        clock's epoch); returns how many spans were resolved."""
        with self._lock:
            marks, self._device_marks = self._device_marks, []
        if not marks:
            return 0
        clock = self.device_clock
        clock.synchronize()
        times = [(clock.seconds(clock.epoch, d0), clock.seconds(d0, d1))
                 for _, d0, d1 in marks]
        with self._lock:
            for (event, _, _), (ts, dur) in zip(marks, times):
                event["dev_ts"], event["dev_dur"] = ts, dur
        return len(marks)

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

    # -- counters -------------------------------------------------------------

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

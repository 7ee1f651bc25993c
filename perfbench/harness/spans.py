"""The traced window read through the port's own layer spans.

``SpanTrace`` is ``trace.Trace`` with a device clock given to the
window's recorder: the port's spans opened with ``device_time=True``
(``round``, ``fused_round``, ``clip``, ``ghost.norms``, ``model.loss_fn``,
``model.loss``, ...) are marked on the card's stream at entry and exit
(``repro_torch.obs.device.CudaClock``'s CUDA events), so each has an
interval on the device's own clock beside its host one.

The profiler's clock does not run even with the device's: against CUDA
events its timestamps bent by up to 3–5 ms in the middle of a 10 s
window and back at its end on an H100, in some profiler sessions and not
in others.  So every mark the window's spans make also launches an empty
spin kernel right behind its event (an anchor, which the profiler sees),
and device times map onto the profiler's clock piecewise linearly
through the anchors (``pair_anchors``), the clock's epoch (recorded right
before the start marker kernel) and its last mark (right before the end
marker).
``clock_skew_us`` is how far the last mark and the end marker disagree
over the window, ``clock_warp_us`` how far the profiler put an anchor
from where the two markers alone would put it.  Each marker's mark is an
event made before the window and recorded again behind a spin kernel
that holds the stream while the mark and the marker queue up, so it
runs as the spin ends, however long the host takes to record it (making
and recording an event took 0.1–0.3 ms of host time under the profiler).
The two spins, about 2 ms, are busy time outside any program span; the
anchors take a few us each at the spans' edges.

``SpanSummary`` holds the base summary's fields, computed by the base
class as before, and adds:

  * ``device_s_by_span`` — for each span name, the device's busy seconds
    (the union of the profiler's operation intervals) inside its spans'
    intervals, the device interval where the span has one, else its host
    interval on the profiler's clock; inclusive of nested spans;
  * ``counters`` — the window's counter totals (``rows.real``,
    ``rows.computed``, ``jit_dispatches``, ...);
  * ``covered_s`` — busy seconds inside any top-level program span (one
    that no other recorded span holds on the host's clock: a round, or
    the parts of the round still open when the window closed).

Times inside are profiler microseconds, as in ``trace.py``.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

from perfbench.harness.trace import Trace, TraceSummary, union

Interval = tuple[float, float]
SPIN_CYCLES = 2_000_000      # about 1 ms at the H100's 1.98 GHz


def overlap(a: float, b: float, merged: list[Interval],
            starts: list[float]) -> float:
    """Length of [a, b] inside the disjoint, sorted ``merged`` intervals
    (``starts`` their starts)."""
    total = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(a, merged[i][0]), min(b, merged[i][1])
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def subtract(keep: list[Interval], drop: list[Interval]) -> list[Interval]:
    """The parts of the disjoint, sorted ``keep`` outside ``drop``."""
    out = []
    drop = union(drop)
    for a, b in keep:
        at = a
        for c, d in drop:
            if d <= at or c >= b:
                continue
            if c > at:
                out.append((at, c))
            at = max(at, d)
        if at < b:
            out.append((at, b))
    return out


@dataclasses.dataclass
class SpanSummary(TraceSummary):
    device_s_by_span: dict[str, float] = dataclasses.field(
        default_factory=dict)
    counters: dict[str, float] = dataclasses.field(default_factory=dict)
    covered_s: float = 0.0
    clock_skew_us: float | None = None
    clock_warp_us: float | None = None
    anchors: tuple[int, int] = (0, 0)   # anchor kernels kept, marks made
    # (start, end, name) of every device operation; (start, end, name,
    # top-level) of every span, on the device's clock where it has one
    ops: list = dataclasses.field(default_factory=list, repr=False)
    spans: list = dataclasses.field(default_factory=list, repr=False)

    def breakdown(self, top: int = 10) -> dict:
        out = super().breakdown(top)
        spans = sorted(self.device_s_by_span.items(), key=lambda kv: -kv[1])
        out["device_spans"] = [[n, s] for n, s in spans[:top]]
        return out

    def kernel_share(self, kernels: tuple[str, ...], inside: tuple[str, ...],
                     outside: tuple[str, ...] = ()) -> float | None:
        """The share of the device seconds of the operations whose name
        holds any of ``kernels`` that lies inside the spans named in
        ``inside`` and outside those named in ``outside``; None when no
        such operation ran."""
        def named(names):
            return [(a, b) for a, b, n, _ in self.spans if n in names]

        where = subtract(union(named(inside)), named(outside))
        starts = [a for a, _ in where]
        total = hit = 0.0
        for a, b, name in self.ops:
            if any(k in name for k in kernels):
                total += b - a
                hit += overlap(a, b, where, starts)
        return hit / total if total > 0 else None


def top_level(events: list[dict]) -> list[bool]:
    """For each span event, whether no other of ``events`` holds it on the
    host's clock."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i]["ts"], -events[i]["dur"]))
    top, end = [False] * len(events), float("-inf")
    for i in order:
        ev_end = events[i]["ts"] + events[i]["dur"]
        if ev_end > end:
            top[i], end = True, ev_end
    return top


def reduce_spans(spans: list[tuple[float, float, str, bool]],
                 busy: list[Interval]) -> tuple[dict[str, float], float]:
    """(busy seconds inside each span name's intervals, busy seconds inside
    any top-level span) from the device's ``busy`` union; times in
    microseconds."""
    starts = [a for a, _ in busy]
    by_span: dict[str, float] = {}
    for a, b, name, _ in spans:
        by_span[name] = by_span.get(name, 0.0) + \
            overlap(a, b, busy, starts) * 1e-6
    tops = union([(a, b) for a, b, _, top in spans if top])
    covered = sum(overlap(a, b, busy, starts) for a, b in tops) * 1e-6
    return by_span, covered


class _AnchoredClock:
    """A ``CudaClock`` whose marks, while ``anchoring``, each launch an
    empty spin kernel right behind their event, so that the profiler sees
    every mark: the k-th anchor kernel of the trace is the k-th mark."""

    def __init__(self) -> None:
        from repro_torch.obs.device import CudaClock

        self._cuda = CudaClock()
        self.epoch, self.seconds = self._cuda.epoch, self._cuda.seconds
        self.synchronize = self._cuda.synchronize
        self.anchoring = False
        self.marks: list = []

    def mark(self):
        event = self._cuda.mark()
        if self.anchoring:
            torch.cuda._sleep(0)
            self.marks.append(event)
        return event


def pair_anchors(marks: list[float], anchors: list[float], origin: float
                 ) -> list[tuple[float, float]]:
    """(mark's device us, its anchor's profiler us) of each mark whose
    anchor the profiler kept, both in stream order.  The profiler may lose
    a record or two in a dense window; where one is missing, the mark whose
    pairing keeps the clocks' offset closer to the last pair's goes
    without (a wrong choice moves a pair by the distance between two
    consecutive marks, where those are too close to tell apart)."""
    pairs, lost, j, last = [], len(marks) - len(anchors), 0, origin
    for i, x in enumerate(marks):
        if j == len(anchors):
            break
        here = anchors[j] - x
        if lost and i + 1 < len(marks) and \
                abs(anchors[j] - marks[i + 1] - last) < abs(here - last):
            lost -= 1
            continue
        pairs.append((x, anchors[j]))
        last, j = here, j + 1
    return pairs


def interpolate(x: float, xs: list[float], ys: list[float]) -> float:
    """The piecewise-linear map through (xs, ys) at ``x`` (xs sorted;
    extended linearly past either end)."""
    i = min(max(bisect.bisect_right(xs, x), 1), len(xs) - 1)
    x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0) if x1 > x0 else y0


class SpanTrace(Trace):
    """``Trace`` whose recorder times the port's device spans on the card;
    ``summary`` is a ``SpanSummary`` after ``stop``."""

    def start(self) -> None:
        self._clock = _AnchoredClock()   # its epoch made now
        self._end = self._clock.mark()   # its last mark, made now
        self._marks: list[float] = []
        super().start()
        self._clock.anchoring = True
        self._rec.device_clock = self._clock

    def _mark(self) -> float:
        """The base marker, behind a spin, right after the device clock's
        epoch (the first call) or its last mark."""
        torch.cuda.synchronize()
        t = self._rec.now()
        torch.cuda._sleep(SPIN_CYCLES)
        (self._end if self._marks else self._clock.epoch).record()
        self._marker.add_(1.0)
        torch.cuda.synchronize()
        self._marks.append(t)
        return t

    def stop(self) -> SpanSummary:
        self._clock.anchoring = False
        prof, rec, clock = self._prof, self._rec, self._clock
        base = super().stop()
        rec.resolve_device_times()
        dev = [e for e in prof.events()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
        # the start spin, the start marker, ..., the end spin, the end marker
        order = sorted(dev, key=lambda e: e.time_range.start)
        lo, hi = order[0].time_range.start, order[-1].time_range.start
        # device us -> profiler us through the markers and every anchor
        # (the profiler's clock bends against the device's by up to ms)
        origin = order[1].time_range.start
        clock_us = clock.seconds(clock.epoch, self._end) * 1e6
        spins = [e.time_range.start for e in order
                 if "spin_kernel" in e.name][1:-1]
        xs, ys = [0.0, clock_us], [origin, hi]
        warp = None
        if len(spins) <= len(clock.marks):
            at = [clock.seconds(clock.epoch, m) * 1e6 for m in clock.marks]
            pairs = pair_anchors(at, spins, origin)
            warp = max((abs(y - interpolate(x, xs, ys)) for x, y in pairs),
                       default=0.0)
            pairs = sorted([(0.0, origin)] + pairs + [(clock_us, hi)])
            xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
        t0, t1 = self._marks
        scale = (hi - lo) / (t1 - t0)
        ops = []
        for e in dev:
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b > a:
                ops.append((a, b, e.name))
        busy = union([(a, b) for a, b, _ in ops])
        events = [ev for ev in rec.events() if ev["type"] == "span"]
        spans = []
        for ev, top in zip(events, top_level(events)):
            if "dev_ts" in ev:
                a = interpolate(ev["dev_ts"] * 1e6, xs, ys)
                b = interpolate((ev["dev_ts"] + ev["dev_dur"]) * 1e6, xs, ys)
            else:
                a = lo + (ev["ts"] - t0) * scale
                b = a + ev["dur"] * scale
            spans.append((a, b, ev["name"], top))
        by_span, covered = reduce_spans(spans, busy)
        self.summary = SpanSummary(
            **dataclasses.asdict(base), device_s_by_span=by_span,
            counters=rec.counter_totals(), covered_s=covered,
            clock_skew_us=clock_us - (hi - origin), clock_warp_us=warp,
            anchors=(len(spins), len(clock.marks)), ops=ops, spans=spans)
        return self.summary

"""The traced window: ``torch.profiler`` on the card, the port's own
``repro_torch.obs`` spans on the host, one clock for both.

``Trace.start()`` installs an obs ``Recorder`` (the port's spans: ``round``,
``fused_round``, ``aggregate``, ``host_rng.stack_poisson``,
``jit_dispatch``) and starts the profiler on the device's activity only
(tracing the host's operators too slowed the host enough to leave the
card idle for a third of a round).  The device is idle at each end of the
window, so a marker kernel launched at a known recorder time is the
first and the last device operation of the trace; the two map the
recorder's clock onto the profiler's, and bound the window.

``Trace.stop()`` reduces the trace to what the readers need: the device's
busy seconds (the union of its operations' intervals), each operation's
device seconds by name, and the idle gaps, each labelled by the innermost
host span open at its middle (the benchmark's own ``perfbench.window``
where the port has none).
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

WINDOW_SPAN = "perfbench.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s_by_name: dict[str, float]
    idle_by_label: dict[str, float]

    def device_seconds(self, *substrings: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``substrings``."""
        return sum(s for name, s in self.device_s_by_name.items()
                   if any(sub in name for sub in substrings))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(busy: list[tuple[float, float]], lo: float, hi: float
              ) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no merged interval of ``busy`` covers."""
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_gaps(gaps: list[tuple[float, float]],
               spans: list[tuple[float, float, int, str]]
               ) -> dict[str, float]:
    """Idle seconds by the innermost span (largest depth) open at each
    gap's middle; times in microseconds."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    out: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        best = None
        for s in spans[:bisect.bisect_right(starts, mid)]:
            if s[1] >= mid and (best is None or s[2] >= best[2]):
                best = s
        label = best[3] if best is not None else WINDOW_SPAN
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


class Trace:
    """Profile one window; ``summary`` holds the reduction after ``stop``."""

    def __init__(self) -> None:
        self.summary: TraceSummary | None = None

    def _mark(self) -> float:
        """Launch the marker on an idle device; the recorder's time."""
        torch.cuda.synchronize()
        t = self._rec.now()
        self._marker.add_(1.0)
        torch.cuda.synchronize()
        return t

    def start(self) -> None:
        import repro_torch.obs as obs

        self._marker = torch.zeros(1, device="cuda")
        self._rec = obs.enable()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = self._mark()

    def stop(self) -> TraceSummary:
        import repro_torch.obs as obs

        t1 = self._mark()
        self._prof.stop()
        obs.disable()
        dev = [e for e in self._prof.events()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
        if len(dev) < 2:
            raise RuntimeError("the profiler's trace holds no device "
                               "operations")
        lo = min(e.time_range.start for e in dev)
        hi = max(e.time_range.start for e in dev)
        # recorder seconds -> profiler microseconds
        scale = (hi - lo) / (t1 - self._t0)

        def to_us(t: float) -> float:
            return lo + (t - self._t0) * scale

        by_name: dict[str, float] = {}
        intervals = []
        for e in dev:
            a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if b <= a:
                continue
            intervals.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) * 1e-6
        busy = union(intervals)
        spans = [(to_us(ev["ts"]), to_us(ev["ts"] + ev["dur"]), ev["depth"],
                  ev["name"])
                 for ev in self._rec.events() if ev["type"] == "span"]
        self.summary = TraceSummary(
            window_s=(hi - lo) * 1e-6,
            busy_s=sum(b - a for a, b in busy) * 1e-6,
            device_s_by_name=by_name,
            idle_by_label=label_gaps(idle_gaps(busy, lo, hi), spans))
        self._prof = None
        return self.summary

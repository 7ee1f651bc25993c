"""Discrete-event engine for the multi-hospital simulator.

The port's copy of ``repro.sim.engine`` (host Python, no tensors): the
heap orders events by ``(time, seq)``, so events fire in the reference's
order, ties included.

A priority-queue simulated clock: events are scheduled at absolute simulated
times, popped in time order (FIFO within a timestamp), and dispatched to a
handler.  The engine knows nothing about federated learning — the
backend (``repro_torch.arms.runners.SimRunner``) schedules the typed
events below and advances its own state in the handlers.  Simulated
time is completely decoupled from wall time, so a 5-hospital day-long
training run replays in milliseconds.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Iterator

# -- typed events -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComputeDone:
    """A node finished local computation (one batch / one local step)."""

    node: int
    tag: str = ""
    payload: Any = None


@dataclasses.dataclass(frozen=True)
class TransferDone:
    """Bytes finished traversing the src -> dst link."""

    src: int
    dst: int
    nbytes: float
    tag: str = ""
    payload: Any = None


@dataclasses.dataclass(frozen=True)
class NodeDropout:
    """A hospital goes offline (crash / network partition / maintenance)."""

    node: int


@dataclasses.dataclass(frozen=True)
class NodeRejoin:
    """A previously-offline hospital comes back."""

    node: int


Event = ComputeDone | TransferDone | NodeDropout | NodeRejoin


# -- engine -----------------------------------------------------------------


class EventEngine:
    """Priority-queue simulated clock with cancellation.

    ``schedule`` returns an opaque handle usable with ``cancel`` (e.g. void a
    node's pending upload when its dropout fires first).  ``now`` only moves
    forward, and only when an event is popped.
    """

    def __init__(self) -> None:
        self.now: float = 0.0
        self.processed: int = 0
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._cancelled: set[int] = set()

    def __len__(self) -> int:
        return len(self._heap) - len(self._cancelled)

    def schedule(self, delay: float, event: Event) -> int:
        """Enqueue ``event`` at ``now + delay``; returns a cancel handle."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        return self.schedule_at(self.now + delay, event)

    def schedule_at(self, time: float, event: Event) -> int:
        if time < self.now:
            raise ValueError(f"cannot schedule in the past ({time} < {self.now})")
        handle = next(self._seq)
        heapq.heappush(self._heap, (time, handle, event))
        return handle

    def cancel(self, handle: int) -> None:
        self._cancelled.add(handle)

    def pop(self) -> Event | None:
        """Next live event in time order; advances ``now``.  None when empty."""
        while self._heap:
            time, handle, event = heapq.heappop(self._heap)
            if handle in self._cancelled:
                self._cancelled.discard(handle)
                continue
            self.now = time
            self.processed += 1
            return event
        return None

    def pending_kinds(self) -> set[type]:
        """Types of events still queued (ignoring cancelled ones)."""
        return {
            type(e) for _, h, e in self._heap if h not in self._cancelled
        }

    def peek_time(self) -> float | None:
        """Timestamp of the next live event without popping it."""
        while self._heap and self._heap[0][1] in self._cancelled:
            _, handle, _ = heapq.heappop(self._heap)
            self._cancelled.discard(handle)
        return self._heap[0][0] if self._heap else None

    def run(
        self,
        handler: Callable[[Event], None],
        *,
        until: float | None = None,
        max_events: int | None = None,
    ) -> int:
        """Dispatch events to ``handler`` until empty / ``until`` / cap."""
        n = 0
        while True:
            if max_events is not None and n >= max_events:
                return n
            t = self.peek_time()
            if t is None or (until is not None and t > until):
                if until is not None and t is not None:
                    self.now = until
                return n
            handler(self.pop())
            n += 1

    def drain(self) -> Iterator[Event]:
        """Iterate remaining events in time order (testing convenience)."""
        while (ev := self.pop()) is not None:
            yield ev

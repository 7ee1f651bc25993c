"""Per-hospital compute/availability model for the simulator.

The port's copy of ``repro.sim.nodes`` (host Python).

A ``HospitalNode`` is the systems-side twin of an ``arms.Participant``:
where the participant holds the private shard, the node holds the hardware
story — training throughput (examples/second), fixed per-round overhead
(data loading, clipping setup, attestation...), and an availability trace of
``(t_off, t_on)`` windows that the protocol adapters turn into
``NodeDropout`` / ``NodeRejoin`` events.

Traces are plain dicts so scenario files stay JSON-serialisable:

    {"throughput": 250.0, "overhead": 0.05, "dropouts": [[120.0, 300.0]]}
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass
class HospitalNode:
    """Compute/availability model for one hospital."""

    index: int
    throughput: float          # training examples processed per sim-second
    overhead: float = 0.0      # fixed seconds per local round/step
    # (t_off, t_on) windows; t_on = None means the node never comes back
    dropouts: tuple[tuple[float, float | None], ...] = ()
    online: bool = True        # mutable runtime state, driven by the engine

    def __post_init__(self) -> None:
        if self.throughput <= 0:
            raise ValueError(f"node {self.index}: throughput must be > 0")
        if self.overhead < 0:
            raise ValueError(f"node {self.index}: negative overhead")
        for t_off, t_on in self.dropouts:
            if t_on is not None and t_on <= t_off:
                raise ValueError(
                    f"node {self.index}: rejoin {t_on} <= dropout {t_off}"
                )

    def compute_time(self, n_examples: int) -> float:
        """Simulated seconds to process one local batch of ``n_examples``."""
        return self.overhead + n_examples / self.throughput


def node_from_trace(index: int, trace: Mapping) -> HospitalNode:
    dropouts = tuple(
        (float(w[0]), None if w[1] is None else float(w[1]))
        for w in trace.get("dropouts", ())
    )
    return HospitalNode(
        index=index,
        throughput=float(trace["throughput"]),
        overhead=float(trace.get("overhead", 0.0)),
        dropouts=dropouts,
    )


def nodes_from_trace(traces: Sequence[Mapping]) -> list[HospitalNode]:
    """Build the cohort from a list of per-hospital trace dicts."""
    return [node_from_trace(i, t) for i, t in enumerate(traces)]


def heterogeneous_trace(
    n: int = 5,
    *,
    fastest: float = 500.0,
    slowdown: float = 0.55,
    overhead: float = 0.02,
) -> list[dict]:
    """A default heterogeneous cohort: geometric throughput spread.

    Hospital 0 is a research centre with ``fastest`` examples/sec; each
    subsequent hospital is ``slowdown`` times slower (node n-1 is the
    community-hospital straggler).  No dropouts — callers inject those.
    """
    return [
        {"throughput": fastest * slowdown**i, "overhead": overhead}
        for i in range(n)
    ]

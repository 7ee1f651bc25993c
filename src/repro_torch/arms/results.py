"""The result type of a run: ``RunReport``, with one ``RoundLog`` per round.

Counterpart of ``repro.arms.results``: training outputs (params, logs,
epsilon) are always present; the systems story (simulated wall-clock,
bytes on the wire, dropout bookkeeping) lives in ``SimTiming``, which only
the simulated-time backend fills in.  The reference's legacy spellings
(``per_client_params``, ``wall_clock``, ...) come with its deprecated
shims (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class RoundLog:
    """One communication round (or, for node arms, one lockstep of steps)."""

    round: int
    leader: int
    loss: float
    epsilon: float
    aggregate_batch: int


@dataclasses.dataclass
class SimTiming:
    """Systems metrics only the discrete-event backend can produce."""

    wall_clock: float = 0.0       # simulated seconds
    bytes_on_wire: float = 0.0
    dropout_events: int = 0       # NodeDropout events that fired
    recoveries: int = 0           # SecAgg Shamir recoveries performed
    lost_rounds: int = 0          # rounds voided (dead facilitator, empty batch)
    events: int = 0               # engine events processed
    noise_topups: int = 0         # rounds whose DP noise was topped up after
                                  # losing distributed noise shares mid-round


@dataclasses.dataclass
class RunReport:
    """What an (arm, backend) run returns.

    ``timing`` is None on the idealized backend, where everything is free
    and instantaneous; ``per_node_params`` is set by node arms.
    """

    params: Any
    logs: list[RoundLog]
    epsilon: float
    rounds_completed: int
    arm: str = ""
    backend: str = ""
    per_node_params: list[Any] | None = None
    timing: SimTiming | None = None

    def mean_loss(self) -> float:
        """Mean of the logged (finite) round losses; NaN when none exist."""
        vals = [l.loss for l in self.logs if math.isfinite(l.loss)]
        return sum(vals) / len(vals) if vals else float("nan")

"""The result type of a run: ``RunReport``, with one ``RoundLog`` per round.

Counterpart of ``repro.arms.results``: training outputs (params, logs,
epsilon) are always present; the systems story (simulated wall-clock,
bytes on the wire, dropout bookkeeping) lives in ``SimTiming``, which only
the simulated-time backend fills in.

The legacy names remain as aliases where the deprecated shims define
them (``core.federation.RunResult`` and ``sim.protocols.ArmReport`` are
``RunReport``), and the legacy attribute spellings (``per_client_params``,
``wall_clock``, ``bytes_on_wire``, ...) are properties, so pre-refactor
callers keep working unchanged.
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

    # -- legacy RunResult spelling -------------------------------------------

    @property
    def per_client_params(self) -> list[Any] | None:
        return self.per_node_params

    # -- legacy ArmReport spellings (0 when there is no timing section) ------

    @property
    def wall_clock(self) -> float:
        return self.timing.wall_clock if self.timing else 0.0

    @property
    def bytes_on_wire(self) -> float:
        return self.timing.bytes_on_wire if self.timing else 0.0

    @property
    def dropout_events(self) -> int:
        return self.timing.dropout_events if self.timing else 0

    @property
    def recoveries(self) -> int:
        return self.timing.recoveries if self.timing else 0

    @property
    def lost_rounds(self) -> int:
        return self.timing.lost_rounds if self.timing else 0

    @property
    def events(self) -> int:
        return self.timing.events if self.timing else 0

    @property
    def noise_topups(self) -> int:
        return self.timing.noise_topups if self.timing else 0

    def mean_loss(self) -> float:
        """Mean of the logged (finite) round losses; NaN when none exist."""
        vals = [l.loss for l in self.logs if math.isfinite(l.loss)]
        return sum(vals) / len(vals) if vals else float("nan")

"""The result type of a run: ``RunReport``, with one ``RoundLog`` per round.

Counterpart of ``repro.arms.results`` for the ported backend: training
outputs only (the simulated-time section, ``SimTiming``, and the legacy
spellings come with the simulated-time backend).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any


@dataclasses.dataclass
class RoundLog:
    """One communication round."""

    round: int
    leader: int
    loss: float
    epsilon: float
    aggregate_batch: int


@dataclasses.dataclass
class RunReport:
    """What an (arm, backend) run returns."""

    params: Any
    logs: list[RoundLog]
    epsilon: float
    rounds_completed: int
    arm: str = ""
    backend: str = ""

    def mean_loss(self) -> float:
        """Mean of the logged (finite) round losses; NaN when none exist."""
        vals = [l.loss for l in self.logs if math.isfinite(l.loss)]
        return sum(vals) / len(vals) if vals else float("nan")

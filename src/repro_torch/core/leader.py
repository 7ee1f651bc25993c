"""Rotating-leader selection (paper Step 1 / Decentralisation section).

Counterpart of ``repro.core.leader``.  The leader only *facilitates*
(aggregates + redistributes); a shared-seed schedule is enough, since
every participant derives the same schedule locally.

``round_robin`` and ``balanced`` are the reference's, number for number.
``uniform`` draws i.i.d. leaders with a seeded numpy generator: the
reference uses ``jax.random.randint``, which the port cannot reproduce, so
the two schedules differ (ROADMAP.md, Queue 3).  On the ideal backend
without SecAgg only ``RoundLog.leader`` reads it; no number depends on it.
"""

from __future__ import annotations

import numpy as np


def leader_schedule(
    n_participants: int,
    n_rounds: int,
    *,
    seed: int = 0,
    strategy: str = "uniform",
) -> np.ndarray:
    """Leader index per communication round.

    strategies:
      uniform     — paper default: i.i.d. uniform over participants each round.
      round_robin — deterministic rotation (fairest load; beyond-paper option).
      balanced    — random permutations chained (uniform marginals, exact
                    long-run fairness; beyond-paper option).
    """
    if n_participants <= 0 or n_rounds < 0:
        raise ValueError("need n_participants > 0, n_rounds >= 0")
    if strategy == "uniform":
        return np.random.default_rng(seed).integers(0, n_participants,
                                                    n_rounds)
    if strategy == "round_robin":
        return np.arange(n_rounds) % n_participants
    if strategy == "balanced":
        rng = np.random.default_rng(seed)
        out = []
        while len(out) < n_rounds:
            out.extend(rng.permutation(n_participants).tolist())
        return np.asarray(out[:n_rounds])
    raise ValueError(f"unknown strategy {strategy!r}")

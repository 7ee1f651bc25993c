"""The first-class cohort sampler: per-round Poisson subsampling of hospitals.

Counterpart of ``repro.population.sampler``: the same ``random.Random``
streams, so cohorts are the reference's, index for index.

The paper's DP accountant (``core.accountant``) analyses the Sampled
Gaussian Mechanism — it has assumed Poisson subsampling since the seed —
but the repo never actually *sampled*: every backend ran every hospital
every round.  ``CohortSampler`` closes that gap: each round, every hospital
joins the cohort independently with probability ``q``
(``ArmConfig.participation_rate``), and the same ``q`` is what the arm
hands its accountant (``rate * participation_rate`` — see
``DeCaPHArm``), so ε accounting and simulation agree by construction.

Two-level-sampling caveat (documented, conservative direction): the
accountant treats the composition as example-level Poisson sampling at
rate ``q * rate``.  The real mechanism samples hospitals at ``q`` and then
examples at ``rate`` within each sampled hospital; for any one example the
marginal inclusion probability is exactly ``q * rate``, and the amplified
RDP of the two-level scheme is bounded by the example-level analysis at
that marginal rate for the per-example-clipped sums the arms upload.
Hospitals offline at round start only *shrink* the realised cohort below
``q``'s expectation, which weakens the mechanism's data exposure, never
strengthens it — the accountant stays an upper bound.

Determinism: the round-``t`` draw comes from its own
``random.Random(f"{seed}:{t}")`` stream (string seeds hash via SHA-512,
stable across Python versions), so cohorts are a pure function of
``(seed, t)`` — independent of execution order, resumable mid-run, and
identical between the trace phase and any re-trace (the byte-identical
contract in DESIGN.md §10).
"""

from __future__ import annotations

import random


class CohortSampler:
    """Poisson (independent Bernoulli-``q``) subsampling over ``h`` hospitals."""

    def __init__(self, h: int, q: float, seed: int) -> None:
        if not 0.0 < q <= 1.0:
            raise ValueError(f"participation rate q must be in (0, 1], got {q}")
        if h < 1:
            raise ValueError("need at least one hospital")
        self.h = h
        self.q = q
        self.seed = seed
        # empirical bookkeeping: over many rounds, selected/offered -> q
        self.offered = 0
        self.selected = 0

    def cohort(self, t: int) -> list[int]:
        """Round ``t``'s sampled cohort, ascending hospital index."""
        self.offered += self.h
        if self.q >= 1.0:
            # full participation consumes no randomness: with q=1 the
            # population backend is bit-identical to the idealized backend
            self.selected += self.h
            return list(range(self.h))
        rng = random.Random(f"{self.seed}:{t}")
        out = [i for i in range(self.h) if rng.random() < self.q]
        self.selected += len(out)
        return out

    def empirical_rate(self) -> float:
        """Fraction of (hospital, round) slots actually sampled so far."""
        return self.selected / self.offered if self.offered else 0.0

"""The idealized host backend that consumes registered round arms.

Counterpart of the ``ideal`` half of ``repro.arms.runners``:
``LocalRunner`` is the lockstep executor (every hospital infinitely fast
and always online, free communication — the paper's utility experiments).
The simulated-time ``SimRunner`` and node arms (gossip) are still to port.
SecAgg is refused at validation (``backends.validate_run``), so the
aggregate is the fused round's own ascending-order sum on the device.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.arms.backends import IDEAL
from repro_torch.arms.base import (
    AggregationServices,
    Arm,
    RoundArm,
    tree_bytes,
)
from repro_torch.arms.results import RoundLog, RunReport
from repro_torch.tree import Tree


class _IdealServices(AggregationServices):
    """Free, lossless aggregation: the fused round already reduced the
    cohort on the device, in ascending-slot order."""

    def __init__(self, fused_reduced: Tree, cover: frozenset[int]) -> None:
        self.fused_reduced = fused_reduced
        self._cover = cover

    def sum_sizes(self, sizes: Sequence[int]) -> int:
        return int(sum(sizes))

    def sum_payloads(self, payloads: Mapping[int, Tree]) -> Tree:
        if set(payloads) != self._cover:
            raise RuntimeError(
                "the fused round's reduced sum does not cover this "
                "aggregation — arm and backend disagree about the cohort"
            )
        return self.fused_reduced


class LocalRunner:
    """Idealized lockstep execution of a round arm, one fused cohort step
    per round."""

    info = IDEAL
    backend = IDEAL.name  # the RunReport.backend label

    def __init__(self, on_round=None) -> None:
        self.on_round = on_round  # on_round(t, params) after each round

    def run(self, arm: Arm) -> RunReport:
        if not isinstance(arm, RoundArm):
            raise NotImplementedError(
                f"arm {arm.name!r} is a {arm.mode!r} arm; the port runs round "
                "arms only so far (ROADMAP.md, Queue 1 item 5)")
        cfg, h = arm.cfg, arm.h
        params = arm.init_params()
        model_bytes = tree_bytes(params, cfg.bytes_per_param)
        rng = np.random.default_rng(cfg.seed)
        logs: list[RoundLog] = []
        for t in range(arm.planned_rounds()):
            with obs.span("round", cat="train", arm=arm.name,
                          backend=self.backend, t=t):
                active = [i for i in range(h) if arm.participates(i, t)]
                if not active:
                    break  # nobody left who can contribute
                dst = arm.facilitator(t, active)
                # one program call for the whole cohort; the reduced
                # aggregate never leaves the device
                with obs.span("fused_round", cat="train", t=t,
                              cohort=len(active)):
                    contribs, reduced = arm.fused_round(params, active, t,
                                                        rng, len(active))
                services = _IdealServices(reduced, frozenset(contribs))
                with obs.span("aggregate", cat="train", t=t, secure=False):
                    outcome = arm.aggregate(params, contribs, services)
                if outcome.stepped:
                    params = outcome.params
                    arm.account()
                    obs.counter("rounds_completed", 1)
                    obs.ledger_round(arm, round=t, backend=self.backend,
                                     cohort=active, delivered=contribs,
                                     bytes_up=model_bytes)
                    logs.append(RoundLog(t, dst, outcome.loss, arm.epsilon(),
                                         outcome.aggregate_batch))
                    if self.on_round is not None:
                        self.on_round(t, params)
                    if arm.should_stop():
                        break
                elif arm.void_logs:
                    logs.append(RoundLog(t, dst, float("nan"), arm.epsilon(),
                                         0))
        return RunReport(
            params=params, logs=logs, epsilon=arm.epsilon(),
            rounds_completed=len(logs), arm=arm.name, backend=self.backend,
        )

"""The idealized host backend that consumes registered round arms.

Counterpart of the ``ideal`` half of ``repro.arms.runners``:
``LocalRunner`` is the lockstep executor (every hospital infinitely fast and
always online, free communication — the paper's utility experiments).
The simulated-time ``SimRunner`` and node arms (gossip) are still to port.

Secure aggregation is a backend service, never implemented inside an arm:
with SecAgg on, the batch sizes are summed by ``secure_sum_ints`` and the
payloads (which the fused round brings to the host in one copy) by an
honest-but-curious ``secure_sum``; with it off, the aggregate is the fused
round's own ascending-order sum on the device.
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
from repro_torch.core.secagg import SecAggConfig, secure_sum, secure_sum_ints
from repro_torch.tree import Tree, tree_device


class _IdealServices(AggregationServices):
    """Free, lossless aggregation: SecAgg over the payload trees when
    ``secure``, else the fused round's own reduction on the device."""

    def __init__(self, cfg, n: int, t: int, secure: bool, device,
                 fused_reduced: Tree | None, cover: frozenset[int]) -> None:
        self._cfg, self._n, self._t, self._secure = cfg, n, t, secure
        self._device = device
        self.fused_reduced = fused_reduced
        self._cover = cover

    def sum_sizes(self, sizes: Sequence[int]) -> int:
        if self._secure:
            # aggregate mini-batch size ||B^t|| via SecAgg — summed in the
            # field as integers (exact, no float fixed-point round-trip)
            return secure_sum_ints(
                list(sizes), n_participants=self._n,
                seed=self._cfg.seed * 7919 + self._t,
            )
        return int(sum(sizes))

    def sum_payloads(self, payloads: Mapping[int, Tree]) -> Tree:
        if self._secure:
            trees = [payloads[i] for i in sorted(payloads)]
            if len(trees) != self._n or any(tr is None for tr in trees):
                raise ValueError(
                    "idealized SecAgg needs every participant's upload "
                    f"({sum(tr is not None for tr in trees)} of {self._n})"
                )
            return secure_sum(
                trees,
                SecAggConfig(self._n, self._cfg.secagg_frac_bits,
                             seed=self._cfg.seed + self._t),
                device=self._device,
            )
        if self.fused_reduced is None or set(payloads) != self._cover:
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
                "arms only so far (ROADMAP.md, Queue 1 item 5b)")
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
                secure = arm.secure_uploads and cfg.use_secagg
                # one program call for the whole cohort; with SecAgg off
                # the reduced aggregate never leaves the device, with it on
                # the payloads leave in one copy and nothing is reduced
                with obs.span("fused_round", cat="train", t=t,
                              cohort=len(active)):
                    contribs, reduced = arm.fused_round(
                        params, active, t, rng, len(active),
                        payloads=secure)
                services = _IdealServices(cfg, h, t, secure,
                                          tree_device(params), reduced,
                                          frozenset(contribs))
                # SecAgg (when on) runs inside aggregate via the services;
                # the span covers the secure sums and the model step
                with obs.span("aggregate", cat="train", t=t, secure=secure):
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

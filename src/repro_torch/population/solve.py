"""The solve phase: topologically execute the traced compute graph.

Counterpart of ``repro.population.solve``.  Where the trace phase decided
*when* everything happens, the solver decides nothing — it walks the
trace's rounds in topological order (the graph's aggregate chain) and
executes each round's cohort as ONE fused cohort step
(``RoundArm.fused_round``, DESIGN.md §7): one counted program call and one
host sync per round, however many hospitals the cohort holds.

Randomness contract (DESIGN.md §10): the solver owns one host
``np.random.Generator`` seeded from the config, consumed strictly in
(executed round, ascending participant index) order.  Rounds the trace
voided *before* compute (below quorum, dead hub) consume nothing; with
``q=1`` and an ideal trace the stream is consumed exactly as the idealized
backend would, which is what makes ``population`` bit-identical to
``ideal`` there (pinned by ``tests/test_torch_population.py``).

Delivery is replayed from the trace: when every sampled upload arrived the
round's aggregate stays on the device (``payloads=None``, the fused
round's ascending fold); when the trace dropped uploads mid-round the
solver takes every participant's payload as a device tree
(``payloads="device"``), sums the delivered subset with the same
ascending fold (``fused.seq_tree_sum``) and — for arms whose noise rides
distributed shares (``distributed_noise``) — adds the conservative
Gaussian top-up that restores the full-cohort noise calibration
(``core.dp.tree_topup_noise``, drawn as ``SimRunner`` draws it).

``SolveReport`` separates the two clocks: simulated seconds come from the
trace, host wall seconds from executing the solve.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.arms import fused
from repro_torch.arms.base import (
    AggregationServices,
    RoundArm,
    batch_loss_fn,
    host_batch,
    tree_bytes,
    tree_sum,
)
from repro_torch.arms.results import RoundLog
from repro_torch.core import dp as dp_lib
from repro_torch.population.trace import Trace
from repro_torch.tree import Tree, tree_device


class _PopulationServices(AggregationServices):
    """Aggregate-level services: plain sums on the device + an optional
    noise top-up."""

    def __init__(self, fused_reduced: Tree | None,
                 cover: frozenset[int],
                 topup: Tree | None = None) -> None:
        self.fused_reduced = fused_reduced
        self._cover = cover
        self._topup = topup

    def sum_sizes(self, sizes: Sequence[int]) -> int:
        return int(sum(sizes))

    def sum_payloads(self, payloads: Mapping[int, Tree]) -> Tree:
        if self.fused_reduced is not None and set(payloads) == self._cover:
            return self.fused_reduced
        total = fused.seq_tree_sum([payloads[i] for i in sorted(payloads)])
        if self._topup is not None:
            total = tree_sum([total, self._topup])
        return total


@dataclasses.dataclass
class SolveReport:
    """What the solve phase did, with simulated vs host time separated."""

    simulated_seconds: float      # the trace's clock (systems story)
    wall_seconds: float           # host time spent executing the solve
    rounds_planned: int
    rounds_completed: int
    lost_rounds: int              # trace-lost + solve-lost (empty draws)
    bytes_on_wire: float
    dropout_events: int
    recoveries: int
    noise_topups: int
    graph_nodes: int
    graph_hash: str
    empirical_q: float
    mean_cohort: float
    evals: list[tuple[int, float]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SolveResult:
    """Training outputs + the report (the backend splices these into a
    ``RunReport``)."""

    params: Any
    logs: list[RoundLog]
    epsilon: float
    report: SolveReport


def solve(
    trace: Trace,
    arm: RoundArm,
    *,
    on_round: Callable[[int, Tree], None] | None = None,
) -> SolveResult:
    """Execute the traced rounds against ``arm``'s fused round-step."""
    cfg = arm.cfg
    # repro: allow[nondeterminism] host wall metric, reported beside (never inside) content-addressed records
    t0 = time.time()
    params = arm.init_params()
    rng = np.random.default_rng(cfg.seed)
    model_bytes = tree_bytes(params, cfg.bytes_per_param)
    logs: list[RoundLog] = []
    completed = 0
    solve_lost = 0
    noise_topups = 0
    evals: list[tuple[int, float]] = []
    eval_rounds = {n.round for n in trace.graph.nodes if n.kind == "eval"}

    for plan in trace.rounds:
      # trace-lost rounds exit the span in microseconds; executed rounds
      # time the fused step + aggregate for the phase breakdown
      with obs.span("round", cat="population", arm=arm.name, t=plan.t,
                    lost=plan.lost):
        if plan.lost:
            continue  # voided pre-compute: no rng consumed (see module doc)
        t = plan.t
        # the arm may veto participants beyond availability (e.g. a local
        # privacy budget exhausted mid-run) — the trace cannot know that
        active = [i for i in plan.cohort if arm.participates(i, t)]
        if not active:
            if arm.empty_break:
                break
            solve_lost += 1
            continue
        delivered_set = set(plan.delivered)
        delivered = [i for i in active if i in delivered_set]
        missing = len(active) - len(delivered)
        if not delivered:
            solve_lost += 1
            continue

        with obs.span("fused_round", cat="train", t=t, cohort=len(active)):
            # whole cohort delivered: the aggregate stays on the device;
            # else every payload comes back as its own device tree
            contribs, reduced = arm.fused_round(
                params, active, t, rng, len(active),
                payloads=None if missing == 0 else "device")

        topup = None
        if missing and arm.distributed_noise:
            # each of the n_shares participants added N(0, (Cσ)²/n) — with
            # ``missing`` shares lost the sum is under-noised; restore the
            # full calibration conservatively (core.dp.tree_topup_noise)
            with obs.span("noise_topup", cat="dp", t=t, missing=missing):
                gen = torch.Generator(device=tree_device(params))
                gen.manual_seed(dp_lib.noise_seed(
                    cfg.seed * 31 + dp_lib.TOPUP_STREAM, t))
                topup = dp_lib.tree_topup_noise(
                    params, gen, clip_norm=cfg.dp.clip_norm,
                    noise_multiplier=cfg.dp.noise_multiplier,
                    missing=missing, n_shares=len(active),
                )
            obs.counter("noise_topups", 1)
            noise_topups += 1

        services = _PopulationServices(
            fused_reduced=reduced, cover=frozenset(delivered), topup=topup,
        )
        with obs.span("aggregate", cat="train", t=t,
                      delivered=len(delivered)):
            outcome = arm.aggregate(
                params, {i: contribs[i] for i in delivered}, services
            )
        if not outcome.stepped:
            solve_lost += 1  # e.g. empty Poisson draw across the cohort
            if arm.void_logs:
                logs.append(RoundLog(t, plan.dst, float("nan"),
                                     arm.epsilon(), 0))
            continue
        params = outcome.params
        arm.account()
        completed += 1
        obs.counter("rounds_completed", 1)
        obs.ledger_round(arm, round=t, backend="population",
                         cohort=active, delivered=delivered,
                         bytes_up=model_bytes, topup=topup is not None)
        logs.append(RoundLog(t, plan.dst, outcome.loss, arm.epsilon(),
                             outcome.aggregate_batch))
        if t in eval_rounds:
            evals.append((t, _eval_loss(arm, params, plan.dst)))
        if on_round is not None:
            on_round(t, params)
        if arm.should_stop():
            break

    report = SolveReport(
        simulated_seconds=trace.wall_clock,
        wall_seconds=time.time() - t0,  # repro: allow[nondeterminism] host wall metric, reported beside (never inside) content-addressed records
        rounds_planned=len(trace.rounds),
        rounds_completed=completed,
        lost_rounds=trace.lost_rounds + solve_lost,
        bytes_on_wire=trace.bytes_on_wire,
        dropout_events=trace.dropout_events,
        recoveries=trace.recoveries,
        noise_topups=noise_topups,
        graph_nodes=len(trace.graph),
        graph_hash=trace.graph.graph_hash(),
        empirical_q=trace.empirical_q,
        mean_cohort=trace.mean_cohort,
        evals=evals,
    )
    return SolveResult(params=params, logs=logs, epsilon=arm.epsilon(),
                       report=report)


def _eval_loss(arm: RoundArm, params: Tree, dst: int,
               probe: int = 64) -> float:
    """Eval-node execution: the mean of the per-example losses over the
    facilitator's probe batch, on the model's device."""
    part = arm.participants[dst % len(arm.participants)]
    n = min(probe, len(part))
    if n == 0:
        return float("nan")
    batch = host_batch({"x": part.x[:n], "y": part.y[:n]},
                       tree_device(params))
    with torch.no_grad():
        losses = batch_loss_fn(arm.model)(params, batch)
    return float(torch.mean(losses))

"""FL — the paper's non-private comparison arm (FedSGD / FedAvg).

Counterpart of ``repro.arms.fl``.  ``fl_local_steps == 1`` is FedSGD with
DeCaPH's sampling/sync cadence (the paper's FL arm); ``> 1`` is FedAvg
(McMahan et al.): each client takes k local SGD steps per round and the
server size-weights the resulting weights.

The fused cohort step loops over the cohort inside one ``instrumented``
call (as ``arms.decaph`` does): every client's masked-sum gradient, or its
k local steps, and the cohort's total or size-weighted average as an
ascending fold on the device.  A draw with no example skips its step,
decided on the host from the draw's count (the reference masks it).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.arms import fused
from repro_torch.arms.base import (
    AggregationServices,
    ArmConfig,
    Contribution,
    Model,
    Participant,
    RoundArm,
    RoundOutcome,
    batch_loss_fn,
    default_pad,
    sgd_update,
    tree_div,
)
from repro_torch.arms.registry import register
from repro_torch.tree import tree_device


@register("fl")
class FLArm(RoundArm):
    """Server-based FL without DP (utility upper bound)."""

    requires_dst_online = True    # classic single point of failure
    topology_kind = "star"
    fused_capable = True

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        n_total = sum(len(p) for p in self.participants)
        self.rate = cfg.batch_size / n_total
        self.pad = default_pad(self.rate, self.participants, cfg)
        self.fedavg = cfg.fl_local_steps > 1
        self._batch_loss = batch_loss_fn(model)
        self._fused_step = fused.instrumented(self._cohort_step)

    def _batch_grad(self, params, batch, mask):
        """Gradient of the mask-weighted sum of the batch's losses."""
        return fused.example_sum(torch.func.grad(
            lambda p: torch.sum(self._batch_loss(p, batch) * mask))(params))

    def _local_step_grad(self, local, batch, mask, k: int, global_params):
        """One local step's gradient (FedProx adds its proximal term);
        ``k`` is the draw's real example count."""
        return tree_div(self._batch_grad(local, batch, mask), max(k, 1))

    def _local_steps(self) -> int:
        return self.cfg.fl_local_steps

    def _local_model(self, params, bxs, bys, ms, ks):
        """One client's local steps from ``params``; empty draws skipped."""
        local = params
        for s, k in enumerate(ks):
            if k == 0:
                continue
            g = self._local_step_grad(local, {"x": bxs[s], "y": bys[s]},
                                      ms[s], k, params)
            local = sgd_update(local, g, self.cfg.lr, self.cfg.weight_decay)
        return local

    def _cohort_step(self, params, bx, by, masks, counts, weights, payloads):
        """Every client's payload (FedSGD: masked-sum gradient; FedAvg: the
        local model) as a list (with ``payloads``) or else the cohort's
        total (FedSGD) or size-weighted average (FedAvg); the one not
        returned is None."""
        slots = fused.cohort_slots(len(bx))
        if self.fedavg:
            stack = [self._local_model(params, bx[s], by[s], masks[s],
                                       counts[s]) for s in slots]
        else:
            stack = [self._batch_grad(params, {"x": bx[s], "y": by[s]},
                                      masks[s]) for s in slots]
        stack = fused.gather_slots(stack, len(bx))
        if payloads:
            return stack, None
        if self.fedavg:
            return None, fused.seq_weighted_sum(stack, weights)
        return None, fused.seq_tree_sum(stack)

    def quorum(self) -> tuple[int, int | None]:
        # server-based FL stalls whenever the hub is offline
        return 1, self.cfg.fl_server

    def facilitator(self, t: int, active: Sequence[int]) -> int:
        return self.cfg.fl_server

    def fused_round(self, params, active, t, rng, n_shares, payloads=None):
        steps = self._local_steps() if self.fedavg else None
        cb = fused.stack_poisson(rng, self.participants, active, self.rate,
                                 self.pad, steps=steps)
        # float32 weights, as the reference's in-program weighted sum takes
        weights = (fused.fedavg_weights(
            [float(len(self.participants[i])) for i in active])
            if self.fedavg else None)
        stack, reduced = self._fused_step(
            params, *fused.to_device(cb, tree_device(params)),
            cb.counts.tolist(), weights, payloads)
        return fused.build_contributions(active, None, cb.sizes, stack,
                                         payloads), reduced

    def aggregate(self, params, contributions: Mapping[int, Contribution],
                  services: AggregationServices) -> RoundOutcome:
        order = sorted(contributions)
        if not order:
            return RoundOutcome(params, stepped=False)
        if self.fedavg:  # size-weighted weight averaging
            if services.fused_reduced is not None:
                # the fused program already holds the weighted average
                return RoundOutcome(services.fused_reduced, stepped=True,
                                    aggregate_batch=self.cfg.batch_size)
            weights = fused.fedavg_weights(
                [float(len(self.participants[i])) for i in order])
            params = fused.seq_weighted_sum(
                [contributions[i].payload for i in order], weights)
            return RoundOutcome(params, stepped=True,
                                aggregate_batch=self.cfg.batch_size)
        agg = services.sum_sizes([contributions[i].size for i in order])
        if agg == 0:
            return RoundOutcome(params, stepped=False)
        total = services.sum_payloads(
            {i: contributions[i].payload for i in order}
        )
        grad = tree_div(total, agg)
        params = sgd_update(params, grad, self.cfg.lr, self.cfg.weight_decay)
        return RoundOutcome(params, stepped=True, aggregate_batch=agg)

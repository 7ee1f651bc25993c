"""SCAFFOLD (Karimireddy et al., 2020) — control-variate FedAvg, as an arm.

Counterpart of ``repro.arms.scaffold``.  FedAvg drifts under heterogeneous
silos; SCAFFOLD corrects every local step with control variates — ``c``
(server) and ``c_i`` (per client):

    y  <-  y - lr * (g_i(y) - c_i + c)

After K local steps the client uploads the model delta and its control
delta (Option II of the paper):

    dy  = y_K - x
    c_i+ = c_i - c + (x - y_K) / (K * lr)      =>   dc = c_i+ - c_i

and the server applies ``x += mean(dy)``, ``c += (|S|/N) * mean(dc)``.

The per-client variates are one stacked ``(H, ...)`` tree on the card; the
cohort step reads each active client's row and adds its ``dc`` to that row
in place, inside the round's one program call.
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
from repro_torch.tree import tree_device, tree_leaves, tree_map


@register("scaffold")
class ScaffoldArm(RoundArm):
    """Control-variate FedAvg: heterogeneity-robust server-based FL."""

    requires_dst_online = True    # classic single point of failure
    topology_kind = "star"
    fused_capable = True

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        n_total = sum(len(p) for p in self.participants)
        self.rate = cfg.batch_size / n_total
        self.pad = default_pad(self.rate, self.participants, cfg)
        # SCAFFOLD only differs from FedSGD when clients take several steps
        self.local_steps = max(2, cfg.fl_local_steps)
        template = model.init_fn(cfg.seed)
        self._c = tree_map(torch.zeros_like, template)
        self._ci = tree_map(
            lambda x: torch.zeros((self.h,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), template)
        self._batch_loss = batch_loss_fn(model)
        self._fused_step = fused.instrumented(self._cohort_step)

    def _batch_grad(self, params, batch, mask):
        """Gradient of the mask-weighted sum of the batch's losses."""
        return fused.example_sum(torch.func.grad(
            lambda p: torch.sum(self._batch_loss(p, batch) * mask))(params))

    def _one_client(self, params, ci, bxs, bys, ms, ks):
        """K corrected local steps for one client; empty draws skipped."""
        cfg, local = self.cfg, params
        for s, k in enumerate(ks):
            if k == 0:
                continue
            g = tree_div(self._batch_grad(local, {"x": bxs[s], "y": bys[s]},
                                          ms[s]), max(k, 1))
            g = tree_map(lambda gl, cs, cl: gl + cs - cl, g, self._c, ci)
            local = sgd_update(local, g, cfg.lr, cfg.weight_decay)
        dy = tree_map(torch.sub, local, params)
        inv_klr = 1.0 / (self.local_steps * cfg.lr)
        dc = tree_map(lambda cs, d: -cs - inv_klr * d, self._c, dy)
        return {"dy": dy, "dc": dc}

    def _cohort_step(self, params, bx, by, masks, counts, active, payloads):
        """Every active client's {dy, dc} (with ``payloads``) or else their
        ascending total; each client's variate row gains its dc in place
        (after every slot is computed: a slot reads only its own row)."""
        stack = [self._one_client(params,
                                  tree_map(lambda st: st[active[s]], self._ci),
                                  bx[s], by[s], masks[s], counts[s])
                 for s in fused.cohort_slots(len(active))]
        stack = fused.gather_slots(stack, len(active))
        for i, payload in zip(active, stack):
            ci = tree_map(lambda st: st[i], self._ci)
            for row, d in zip(tree_leaves(ci), tree_leaves(payload["dc"])):
                row.add_(d)  # c_i+ = c_i + dc, into the stacked tree
        if payloads:
            return stack, None
        return None, fused.seq_tree_sum(stack)

    def quorum(self) -> tuple[int, int | None]:
        return 1, self.cfg.fl_server

    def facilitator(self, t: int, active: Sequence[int]) -> int:
        return self.cfg.fl_server

    def fused_round(self, params, active, t, rng, n_shares, payloads=None):
        cb = fused.stack_poisson(rng, self.participants, active, self.rate,
                                 self.pad, steps=self.local_steps)
        stack, reduced = self._fused_step(
            params, *fused.to_device(cb, tree_device(params)),
            cb.counts.tolist(), list(active), payloads)
        return fused.build_contributions(active, None, cb.sizes, stack,
                                         payloads), reduced

    def aggregate(self, params, contributions: Mapping[int, Contribution],
                  services: AggregationServices) -> RoundOutcome:
        order = sorted(contributions)
        if not order:
            return RoundOutcome(params, stepped=False)
        n = len(order)
        total = services.sum_payloads(
            {i: contributions[i].payload for i in order}
        )
        mean_dy = tree_div(total["dy"], n)
        mean_dc = tree_div(total["dc"], n)
        params = tree_map(torch.add, params, mean_dy)
        self._c = tree_map(lambda cs, d: cs + (n / self.h) * d, self._c,
                           mean_dc)
        agg = int(sum(contributions[i].size for i in order))
        return RoundOutcome(params, stepped=True,
                            aggregate_batch=agg or self.cfg.batch_size)

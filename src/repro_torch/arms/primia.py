"""PriMIA-style local-DP FL as a registered arm.

Counterpart of ``repro.arms.primia``.  Every client runs its own DP-SGD:
local Poisson rate ``B_h / |D_h|``, the FULL noise N(0, (C sigma)^2)
added locally (``n_shares=1``), and a *local* accountant.  A client stops
contributing once another step would overshoot its own epsilon budget —
clients with higher sampling rates (small silos) drop out first, the
forgetting failure mode the paper describes.

The cohort step is decaph's: the same clipped-grad-sum seam (ghost
clipping, through the ``ghost_norm`` kernel on the card, for a model that
declares it), the ragged per-client draws padded to the round's max with
masks keeping the extra rows inert, and each client's noise from a
``torch.Generator`` seeded by ``noise_seed(seed, 31 + t, i)``.
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
    sgd_update,
    tree_div,
)
from repro_torch.arms.registry import register
from repro_torch.core import dp as dp_lib
from repro_torch.core.accountant import RDPAccountant, steps_for_epsilon
from repro_torch.tree import tree_device

# The reference's noise salt, 31 (its fold_in(fold_in(key, 31 + t), i)),
# here as SeedSequence words.
_NOISE_STREAM = 31


@register("primia")
class PriMIAArm(RoundArm):
    """Local-DP FL through a star hub, per-client accountants."""

    private = True
    requires_dst_online = True
    empty_break = True            # every budget exhausted -> run over
    topology_kind = "star"
    fused_capable = True

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        per_client_batch = max(1, cfg.batch_size // self.h)
        self.rates = [
            min(1.0, per_client_batch / max(len(p), 1))
            for p in self.participants
        ]
        self.pads = [
            cfg.max_pad_batch or max(8, int(r * len(p) * 4) or 8)
            for r, p in zip(self.rates, self.participants)
        ]
        self.accts = [
            RDPAccountant(sampling_rate=r,
                          noise_multiplier=cfg.dp.noise_multiplier,
                          delta=cfg.dp.delta)
            for r in self.rates
        ]
        if cfg.epsilon_budget is not None:
            # a client only participates while ANOTHER step stays within its
            # local budget (never overshoots)
            self.max_rounds = [
                steps_for_epsilon(r, cfg.dp.noise_multiplier,
                                  cfg.epsilon_budget, cfg.dp.delta,
                                  max_steps=cfg.rounds + 1)
                for r in self.rates
            ]
        else:
            self.max_rounds = [cfg.rounds] * self.h
        # the pad hint only caps the faithful path's microbatch, so keep
        # the configured microbatch by passing the largest per-client pad
        self._clip_fn = self.clipped_grad_sum_fn(
            max(cfg.dp.microbatch_size, *self.pads))
        self._fused_step = fused.instrumented(self._cohort_step)

    def quorum(self) -> tuple[int, int | None]:
        return 1, self.cfg.fl_server

    def participates(self, i: int, t: int) -> bool:
        return self.accts[i].steps < self.max_rounds[i]

    def facilitator(self, t: int, active: Sequence[int]) -> int:
        return self.cfg.fl_server

    def _cohort_step(self, params, bx, by, masks, counts, t, active,
                     payloads):
        """Every client's locally noised mean gradient (with ``payloads``)
        or else their ascending total, and every client's loss; each client
        divides by its own real-example count."""
        cfg, device = self.cfg, tree_device(params)
        stack, losses = [], []
        for s in fused.cohort_slots(len(active)):
            g_sum, loss = self._clip_fn(params, {"x": bx[s], "y": by[s]},
                                        masks[s])
            gen = torch.Generator(device=device)
            gen.manual_seed(dp_lib.noise_seed(cfg.seed, _NOISE_STREAM + t,
                                              active[s]))
            # local DP: the FULL noise per client (n_shares=1)
            g = dp_lib.tree_add_noise(
                g_sum, gen, clip_norm=cfg.dp.clip_norm,
                noise_multiplier=cfg.dp.noise_multiplier, n_shares=1)
            stack.append(tree_div(g, max(counts[s], 1)))
            losses.append(loss)
        stack = fused.gather_slots(stack, len(active))
        losses = fused.gather_slots(losses, len(active))
        if payloads:
            return stack, None, torch.stack(losses)
        return None, fused.seq_tree_sum(stack), torch.stack(losses)

    def fused_round(self, params, active, t, rng, n_shares, payloads=None):
        # per-client rates *and* pads: each client draws with its own, in
        # loop order, and the stack re-pads to the cohort max
        cb = fused.stack_poisson(rng, self.participants, active, self.rates,
                                 self.pads)
        stack, reduced, losses = self._fused_step(
            params, *fused.to_device(cb, tree_device(params)),
            cb.counts.tolist(), t, list(active), payloads)
        for i in active:
            self.accts[i].step()  # privacy is spent at compute time
        return fused.build_contributions(active, losses, cb.sizes, stack,
                                         payloads), reduced

    def aggregate(self, params, contributions: Mapping[int, Contribution],
                  services: AggregationServices) -> RoundOutcome:
        order = sorted(contributions)
        if not order:
            return RoundOutcome(params, stepped=False)
        total = services.sum_payloads(
            {i: contributions[i].payload for i in order}
        )
        grad = tree_div(total, len(order))
        params = sgd_update(params, grad, self.cfg.lr, self.cfg.weight_decay)
        agg = int(sum(contributions[i].size for i in order))
        return RoundOutcome(params, stepped=True, aggregate_batch=agg)

    def epsilon(self) -> float:
        return max(a.epsilon() for a in self.accts)

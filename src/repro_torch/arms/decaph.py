"""DeCaPH — the paper's framework, Steps 1-7, as a registered arm.

Counterpart of ``repro.arms.decaph``: shared Poisson rate, per-example
clipping (ghost clipping for models that declare it), per-participant
noise shares sized so the **sum** carries N(0, (C sigma)^2), rotating
facilitator, one shared RDP accountant over the aggregate dataset.  SecAgg
is not ported yet, so ``arms.run`` refuses ``use_secagg=True`` for this
arm at validation.

The reference ``vmap``s one participant's step over the cohort; the port
loops over the cohort inside one ``instrumented`` cohort step (the
clipped-sum kernels cannot be vmapped), keeping one program call per
fused round.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
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
    default_pad,
    sgd_update,
    tree_div,
)
from repro_torch.arms.registry import register
from repro_torch.core import dp as dp_lib
from repro_torch.core.accountant import RDPAccountant, steps_for_epsilon
from repro_torch.core.leader import leader_schedule
from repro_torch.tree import tree_device

# The reference's noise salt, 17: it seeds participant i's round-t noise
# generator from (seed, 17 + t, i) as the reference folds (17 + t, i) into
# its key.  These are SeedSequence words, not JAX fold_in salts, so they
# share no key namespace with the reference's _NOISE_SALT.
_NOISE_STREAM = 17


@register("decaph")
class DeCaPHArm(RoundArm):
    """The DeCaPH protocol (distributed-noise DP-SGD behind SecAgg)."""

    secure_uploads = True
    void_logs = True            # an empty Poisson round is logged as NaN

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        n_total = sum(len(p) for p in self.participants)
        self.rate = cfg.batch_size / n_total
        self.pad = default_pad(self.rate, self.participants, cfg)
        self.leaders = leader_schedule(
            self.h, cfg.rounds, seed=cfg.seed, strategy=cfg.leader_strategy
        )
        self.acct = RDPAccountant(
            sampling_rate=self.rate * cfg.participation_rate,
            noise_multiplier=cfg.dp.noise_multiplier,
            delta=cfg.dp.delta,
        )
        # ghost clipping for models declaring the capability, faithful
        # per-example clipping otherwise; noise and accounting are the same
        # either way
        self._clip_fn = self.clipped_grad_sum_fn(self.pad)
        self._fused_step = fused.instrumented(self._cohort_step)

    # --- schedule -------------------------------------------------------------

    def planned_rounds(self) -> int:
        if self.cfg.epsilon_budget is None:
            return self.cfg.rounds
        return min(
            self.cfg.rounds,
            steps_for_epsilon(
                self.rate * self.cfg.participation_rate,
                self.cfg.dp.noise_multiplier,
                self.cfg.epsilon_budget, self.cfg.dp.delta,
                max_steps=self.cfg.rounds + 1,
            ),
        )

    def facilitator(self, t: int, active: Sequence[int]) -> int:
        leader = int(self.leaders[t])
        if leader in active:
            return leader
        # shared-seed schedule: everyone skips to the next online hospital
        return active[t % len(active)]

    # --- numerics ---------------------------------------------------------------

    def _noised(self, g_sum, t: int, i: int, n_shares: int, device):
        """``g_sum`` plus participant ``i``'s noise share of round ``t``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(dp_lib.noise_seed(self.cfg.seed, _NOISE_STREAM + t,
                                          i))
        return dp_lib.tree_add_noise(
            g_sum, gen, clip_norm=self.cfg.dp.clip_norm,
            noise_multiplier=self.cfg.dp.noise_multiplier, n_shares=n_shares,
        )

    def _cohort_step(self, params, bx, by, masks, t, active, n_shares):
        """The cohort total of the noised clipped sums, in ascending-slot
        order, and every participant's loss."""
        device = tree_device(params)
        stack, losses = [], []
        for s, i in enumerate(active):
            g_sum, loss = self._clip_fn(params, {"x": bx[s], "y": by[s]},
                                        masks[s])
            stack.append(self._noised(g_sum, t, i, n_shares, device))
            losses.append(loss)
        return fused.seq_tree_sum(stack), torch.stack(losses)

    def fused_round(self, params, active, t, rng, n_shares):
        cb = fused.stack_poisson(rng, self.participants, active, self.rate,
                                 self.pad)
        device = tree_device(params)
        reduced, losses = self._fused_step(
            params, torch.from_numpy(cb.x).to(device),
            torch.from_numpy(cb.y).to(device),
            torch.from_numpy(cb.masks).to(device), t, list(active), n_shares)
        return fused.build_contributions(active, losses, cb.sizes), reduced

    def aggregate(self, params, contributions: Mapping[int, Contribution],
                  services: AggregationServices) -> RoundOutcome:
        order = sorted(contributions)
        agg_batch = services.sum_sizes([contributions[i].size for i in order])
        if agg_batch == 0:
            return RoundOutcome(params, stepped=False)
        total = services.sum_payloads(
            {i: contributions[i].payload for i in order}
        )
        grad = tree_div(total, agg_batch)
        params = sgd_update(params, grad, self.cfg.lr, self.cfg.weight_decay)
        loss = float(np.mean([contributions[i].loss for i in order]))
        return RoundOutcome(params, stepped=True, loss=loss,
                            aggregate_batch=agg_batch)

    # --- accounting -------------------------------------------------------------

    def account(self) -> None:
        self.acct.step()

    def epsilon(self) -> float:
        return self.acct.epsilon()

    def should_stop(self) -> bool:
        return (
            self.cfg.epsilon_budget is not None
            and self.acct.exceeds(self.cfg.epsilon_budget)
        )

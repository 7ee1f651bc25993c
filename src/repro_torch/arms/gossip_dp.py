"""DP gossip: D-PSGD with local clip + noise per node.

Counterpart of ``repro.arms.gossip_dp``.  Each node runs its own DP-SGD
step (Poisson sampling, per-example clipping, FULL local noise — local DP
like PriMIA) between pairwise averagings, with a per-node RDP accountant;
a node retires once another step would overshoot its epsilon budget.  The
noise comes from a ``torch.Generator`` seeded by
``noise_seed(seed, 53 + step, i)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.arms.base import (
    ArmConfig,
    Model,
    Participant,
    host_batch,
    poisson_batch,
    sgd_update,
    tree_div,
)
from repro_torch.arms.gossip import GossipArm
from repro_torch.arms.registry import register
from repro_torch.core import dp as dp_lib
from repro_torch.core.accountant import RDPAccountant, steps_for_epsilon
from repro_torch.tree import tree_device

# The reference's noise salt, 53, here as SeedSequence words.
_NOISE_STREAM = 53


@register("gossip-dp")
class GossipDPArm(GossipArm):
    """Gossip averaging with per-node local-DP updates and accountants."""

    private = True

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        per_node_batch = max(1, cfg.batch_size // self.h)
        self.rates = [
            min(1.0, per_node_batch / max(len(p), 1))
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
        steps = self.steps_total()
        if cfg.epsilon_budget is not None:  # never overshoot the local budget
            self.max_steps = [
                steps_for_epsilon(r, cfg.dp.noise_multiplier,
                                  cfg.epsilon_budget, cfg.dp.delta,
                                  max_steps=steps + 1)
                for r in self.rates
            ]
        else:
            self.max_steps = [steps] * self.h

    def step_cost(self, i: int) -> int:
        return max(1, int(round(self.rates[i] * len(self.participants[i]))))

    def local_step(self, i, params_i, s):
        if self.accts[i].steps >= self.max_steps[i]:
            return None  # local budget exhausted: node retires from training
        cfg, device = self.cfg, tree_device(params_i)
        b, m, k = poisson_batch(self._rngs[i], self.participants[i],
                                self.rates[i], self.pads[i])
        g_sum, loss = dp_lib.per_example_clipped_grad_sum(
            self.model.loss_fn, params_i, host_batch(b, device),
            clip_norm=cfg.dp.clip_norm,
            microbatch_size=cfg.dp.microbatch_size,
            mask=torch.from_numpy(m).to(device))
        gen = torch.Generator(device=device)
        gen.manual_seed(dp_lib.noise_seed(cfg.seed, _NOISE_STREAM + s, i))
        g = dp_lib.tree_add_noise(
            g_sum, gen, clip_norm=cfg.dp.clip_norm,
            noise_multiplier=cfg.dp.noise_multiplier, n_shares=1)
        g = tree_div(g, max(k, 1))
        params_i = sgd_update(params_i, g, cfg.lr, cfg.weight_decay)
        self.accts[i].step()
        return params_i, loss, k

    def epsilon(self) -> float:
        return max(a.epsilon() for a in self.accts)

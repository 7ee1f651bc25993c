"""Silo-only baseline: one independent non-private model per hospital.

Counterpart of ``repro.arms.local``: each silo draws its batches from its
own stream seeded by (config seed, silo index), so the event backend can
interleave the nodes in simulated-time order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.arms.base import (
    ArmConfig,
    Model,
    NodeArm,
    Participant,
    batch_loss_fn,
    host_batch,
    sgd_update,
)
from repro_torch.arms.registry import register
from repro_torch.tree import tree_device


class SGDNodeArm(NodeArm):
    """A node arm whose local step is plain mini-batch SGD on ``min(batch,
    |silo|)`` examples drawn without replacement from the node's own
    stream ``self._rngs[i]`` (set by the subclass)."""

    _rngs: list[np.random.Generator]

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        self._bs = [min(cfg.batch_size, len(p)) for p in self.participants]
        batch_loss = batch_loss_fn(model)
        self._loss_and_grad = torch.func.grad_and_value(
            lambda p, batch: torch.mean(batch_loss(p, batch)))

    def local_step(self, i, params_i, s):
        part, bs = self.participants[i], self._bs[i]
        idx = self._rngs[i].choice(len(part), size=bs, replace=False)
        batch = host_batch({"x": part.x[idx], "y": part.y[idx]},
                           tree_device(params_i))
        g, loss = self._loss_and_grad(params_i, batch)
        params_i = sgd_update(params_i, g, self.cfg.lr, self.cfg.weight_decay)
        return params_i, loss, bs


@register("local")
class LocalArm(SGDNodeArm):
    """No collaboration: plain mini-batch SGD per silo."""

    topology_kind = "full"  # topology is irrelevant; zero bytes on wire

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        self._rngs = [
            np.random.default_rng([cfg.seed, i]) for i in range(self.h)
        ]

    def steps_total(self) -> int:
        return self.cfg.rounds

    def init_node_params(self, i: int):
        return self.model.init_fn(self.cfg.seed + i)

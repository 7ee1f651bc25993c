"""Asynchronous gossip D-PSGD (Lian et al. 2018 style), non-private.

Counterpart of ``repro.arms.gossip``.  No global rounds: each node
alternates local SGD steps with pairwise model averaging over its topology
neighbours (round-robin).  Under the sim backend communication overlaps
compute; under the idealized backend the same numerics run in lockstep
(all nodes step, then all exchanges fire in node order, matching the event
order of an ideal uniform trace).  Each node's model is its own tree on
the card; the backend averages a pair in place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.arms.base import ArmConfig, Model, Participant
from repro_torch.arms.local import SGDNodeArm
from repro_torch.arms.registry import register
from repro_torch.core import dp as dp_lib
from repro_torch.tree import tree_map


def node_seed(seed: int, i: int) -> int:
    """Node ``i``'s init seed — the port's counterpart of the reference's
    ``fold_in(key(seed), i)``."""
    return dp_lib.noise_seed(seed, i)


@register("gossip")
class GossipArm(SGDNodeArm):
    """Async D-PSGD: local SGD + neighbour averaging, no rounds."""

    topology_kind = "ring"

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        # per-node streams (the reference's seeding, bit for bit)
        self._rngs = [
            np.random.default_rng(cfg.seed * 100_003 + i)
            for i in range(self.h)
        ]
        self._cursor = [0] * self.h

    def init_node_params(self, i: int):
        return self.model.init_fn(node_seed(self.cfg.seed, i))

    def wants_exchange(self, i: int, steps_done: int) -> bool:
        return steps_done % self.cfg.gossip_every == 0

    def select_peer(self, i: int, neighbors: Sequence[int]) -> int | None:
        if not neighbors:
            return None  # every neighbour offline: connection refused
        j = neighbors[self._cursor[i] % len(neighbors)]
        self._cursor[i] += 1
        return j

    def consensus(self, per_node_params):
        total = per_node_params[0]
        for tree in per_node_params[1:]:
            total = tree_map(lambda a, b: a + b, total, tree)
        return tree_map(lambda x: x / self.h, total), per_node_params

"""The Arm/Backend contract: write an arm's numerics once, run it anywhere.

Counterpart of ``repro.arms.base`` for round arms.  An ``Arm`` declares
*what* a federation protocol computes each round — local updates,
aggregation rule, privacy accounting — and nothing about *when*; a
backend (``repro_torch.arms.runners``) executes it.  The port has one
backend so far, the idealized lockstep ``LocalRunner``; node arms
(gossip) and the simulated-time backend are still to port.

Randomness rules, as in the reference:

  * round arms share one host ``np.random.Generator`` consumed strictly in
    (round, ascending participant index) order — the Poisson draws are
    the reference's, number for number;
  * noise generators are seeded by a pure function of (seed, salt + round,
    participant index) (``core.dp.noise_seed``) and therefore never depend
    on execution order.

Parameter trees are plain (nested) dicts of tensors (``repro_torch.tree``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import dp as dp_lib
from repro_torch.tree import Tree, tree_leaves, tree_map

logger = logging.getLogger(__name__)


# -- model / data ------------------------------------------------------------


@dataclasses.dataclass
class Model:
    """Functional model triple shared by every arm.

    ``init_fn(seed)`` returns the parameter tree on the device the model
    was built for; ``loss_fn(params, example)`` is one example's loss.
    """

    init_fn: Callable[[int], Tree]
    loss_fn: Callable[[Tree, Tree], torch.Tensor]
    predict_fn: Callable[[Tree, torch.Tensor], torch.Tensor]
    # optional capability: ghost-clipping support (arms/clipping.py); None =
    # faithful per-example clipping only
    ghost: Any | None = None


@dataclasses.dataclass
class Participant:
    """One hospital: a private (X, y) shard."""

    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.x)


# -- configuration -----------------------------------------------------------


@dataclasses.dataclass
class ArmConfig:
    """One config for every round arm: the reference's fields that the
    ported arms read (the SecAgg, simulation and other arms' knobs come
    with their slices)."""

    rounds: int = 100
    batch_size: int = 64           # desired aggregate mini-batch size B
    lr: float = 0.1
    weight_decay: float = 0.0
    dp: dp_lib.DPConfig = dataclasses.field(default_factory=dp_lib.DPConfig)
    epsilon_budget: float | None = None   # stop when the accountant exceeds it
    use_secagg: bool = True        # SecAgg (not ported: refused at validation)
    leader_strategy: str = "uniform"
    participation_rate: float = 1.0  # < 1 is refused: no backend subsamples
    clipping: str = "auto"         # "auto" | "ghost" | "per-example"
    seed: int = 0
    max_pad_batch: int | None = None  # static padded per-silo batch
    bytes_per_param: float = 4.0   # ledger bytes_up per parameter


# -- shared numerics helpers -------------------------------------------------


def poisson_batch(
    rng: np.random.Generator,
    part: Participant,
    rate: float,
    pad_to: int,
) -> tuple[dict[str, np.ndarray], np.ndarray, int]:
    """Poisson-sample a silo mini-batch, padded to a static shape + mask.

    The returned arrays have leading dimension ``pad_to`` — unless the
    Poisson draw selected *more* than ``pad_to`` examples, in which case the
    pad grows (next power of two that fits) rather than silently truncating
    the draw, which would bias the subsampling and void the privacy
    analysis.
    """
    sel = rng.random(len(part)) < rate
    idx = np.nonzero(sel)[0]
    k = len(idx)
    if k > pad_to:
        grown = 1 << int(np.ceil(np.log2(k)))
        logger.warning(
            "poisson_batch: draw of %d examples exceeded the padded batch %d; "
            "growing the pad to %d for this round. Raise max_pad_batch to "
            "avoid this.", k, pad_to, grown,
        )
        pad_to = grown
    xb = np.zeros((pad_to,) + part.x.shape[1:], part.x.dtype)
    yb = np.zeros((pad_to,) + part.y.shape[1:], part.y.dtype)
    xb[:k] = part.x[idx]
    yb[:k] = part.y[idx]
    mask = np.zeros((pad_to,), np.float32)
    mask[:k] = 1.0
    return {"x": xb, "y": yb}, mask, k


def sgd_update(params: Tree, grads: Tree, lr: float, wd: float) -> Tree:
    """p - lr * (g + wd * p).  Dtypes promote as the reference's do: float32
    gradients make bfloat16 parameters float32 after the first step."""
    return tree_map(lambda p, g: p - lr * (g + wd * p), params, grads)


def tree_sum(trees: Sequence[Tree]) -> Tree:
    """Elementwise sum of a non-empty sequence of trees, in ascending order."""
    total = trees[0]
    for t in trees[1:]:
        total = tree_map(torch.add, total, t)
    return total


def tree_div(tree: Tree, d: float) -> Tree:
    """Elementwise ``x / d`` (not ``x * (1/d)``, as the reference)."""
    return tree_map(lambda x: x / d, tree)


def tree_bytes(tree: Tree, bytes_per_param: float) -> float:
    """Bytes on the wire for one serialised copy of ``tree``."""
    return bytes_per_param * sum(max(leaf.numel(), 1)
                                 for leaf in tree_leaves(tree))


def default_pad(rate: float, participants: Sequence[Participant],
                cfg: ArmConfig) -> int:
    """Static padded batch: 4x the largest silo's expected draw (legacy rule)."""
    return cfg.max_pad_batch or max(
        8, int(rate * max(len(p) for p in participants) * 4)
    )


# -- the per-round exchange types --------------------------------------------


@dataclasses.dataclass
class Contribution:
    """What one participant produces in one round: the ``payload`` tree that
    goes on the wire (None while it stays inside the fused round's reduced
    sum), ``size`` real examples consumed, optional ``loss``."""

    payload: Tree | None
    size: int
    loss: float | None = None


@dataclasses.dataclass
class RoundOutcome:
    """What an arm's ``aggregate`` returns to the backend."""

    params: Tree
    stepped: bool                 # False -> round void (no model update)
    loss: float = float("nan")
    aggregate_batch: int = 0


class AggregationServices:
    """Backend-provided aggregation primitives (DESIGN.md §5).

    ``fused_reduced`` is the cohort aggregate the fused round-step already
    reduced on the device.
    """

    fused_reduced: Tree

    def sum_sizes(self, sizes: Sequence[int]) -> int:  # pragma: no cover
        raise NotImplementedError

    def sum_payloads(self, payloads: Mapping[int, Tree]
                     ) -> Tree:  # pragma: no cover
        raise NotImplementedError


# -- arm base classes --------------------------------------------------------


class Arm:
    """Base for all arms.  Subclass ``RoundArm``, not this."""

    name: str = ""
    mode: str = ""                 # "round" | "node"

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        if not participants:
            raise ValueError("need at least one participant")
        self.model = model
        self.participants = list(participants)
        self.cfg = cfg
        self.h = len(self.participants)

    def epsilon(self) -> float:
        return 0.0

    def should_stop(self) -> bool:
        """Budget exceeded — the backend stops scheduling further rounds."""
        return False


class RoundArm(Arm):
    """Synchronous-round arm: contribute -> aggregate -> broadcast.

    The backend owns the cohort and the secure-sum transcript; the arm owns
    every number that ends up in the model.
    """

    mode = "round"
    secure_uploads = False        # payloads go through SecAgg when enabled
    void_logs = False             # log a NaN round when nothing aggregates

    def clipped_grad_sum_fn(self, pad: int):
        """Model-aware clipped-grad-sum seam (DESIGN.md §12): the ghost path
        for models declaring the capability, the faithful
        ``dp.per_example_clipped_grad_sum`` otherwise — resolved once at arm
        construction so the choice is visible in ``clipping_path``."""
        from repro_torch.arms import clipping as clipping_lib

        self.clipping_path = clipping_lib.resolve(self.model, self.cfg)
        return clipping_lib.clipped_grad_sum_fn(self.model, self.cfg, pad)

    def planned_rounds(self) -> int:
        return self.cfg.rounds

    def participates(self, i: int, t: int) -> bool:
        return True

    def facilitator(self, t: int, active: Sequence[int]) -> int:
        raise NotImplementedError

    def init_params(self) -> Tree:
        return self.model.init_fn(self.cfg.seed)

    def fused_round(self, params: Tree, active: Sequence[int], t: int,
                    rng: np.random.Generator, n_shares: int
                    ) -> tuple[dict[int, Contribution], Tree]:
        """The cohort-batched round step (DESIGN.md §7): every active
        participant's contribution in ONE program call with ONE host sync
        for metrics, and the cohort aggregate reduced on the device.
        Consumes ``rng`` in (round, ascending participant index) order.
        The payloads stay inside the reduced sum (``payload`` is None)."""
        raise NotImplementedError

    def aggregate(self, params: Tree, contributions: Mapping[int, Contribution],
                  services: AggregationServices) -> RoundOutcome:
        raise NotImplementedError

    def account(self) -> None:
        """Advance the accountant after a stepped round (no-op by default)."""

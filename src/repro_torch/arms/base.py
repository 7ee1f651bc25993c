"""The Arm/Backend contract: write an arm's numerics once, run it anywhere.

Counterpart of ``repro.arms.base``.  An ``Arm`` declares *what* a
federation protocol computes each round — local updates, aggregation rule,
privacy accounting, what goes on the wire — and nothing about *when*; a
backend (``repro_torch.arms.runners``) executes it: the idealized lockstep
``LocalRunner`` or the discrete-event ``SimRunner``.  An arm never
observes simulated time, node availability or the engine, so the two
backends produce the same trajectory whenever the simulated conditions are
ideal.

Randomness rules, as in the reference:

  * round arms share one host ``np.random.Generator`` consumed strictly in
    (round, ascending participant index) order — the Poisson draws are
    the reference's, number for number;
  * node arms hold one independent stream per node (the event backend
    interleaves nodes in simulated-time order);
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

import repro_torch.obs as obs
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


def _global_stats(parts: Sequence[Participant]
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Preparation-phase global mean/std via (conceptually) SecAgg sums."""
    n = sum(len(p) for p in parts)
    s = sum(p.x.sum(axis=0) for p in parts)
    mean = s / n
    sq = sum(((p.x - mean) ** 2).sum(axis=0) for p in parts)
    std = np.sqrt(sq / n) + 1e-8
    return mean.astype(np.float32), std.astype(np.float32)


def normalize_participants(parts: Sequence[Participant]) -> list[Participant]:
    """Every silo's features standardised by the cohort's global mean/std
    (the reference's preparation step, the same numpy arithmetic)."""
    mean, std = _global_stats(parts)
    return [Participant((p.x - mean) / std, p.y) for p in parts]


# -- configuration -----------------------------------------------------------


@dataclasses.dataclass
class ArmConfig:
    """One config for every arm on every backend (the reference's fields);
    arm-specific knobs are ignored by arms that do not use them."""

    rounds: int = 100
    batch_size: int = 64           # desired aggregate mini-batch size B
    lr: float = 0.1
    weight_decay: float = 0.0
    dp: dp_lib.DPConfig = dataclasses.field(default_factory=dp_lib.DPConfig)
    epsilon_budget: float | None = None   # stop when the accountant exceeds it
    use_secagg: bool = True        # run the real fixed-point SecAgg protocol
    secagg_frac_bits: int = 16
    secagg_threshold: int | None = None  # None -> majority of round's cohort
    fl_local_steps: int = 1        # >1 = FedAvg (weight averaging) for "fl"
    fedprox_mu: float = 0.1        # proximal-term weight for "fedprox"
    leader_strategy: str = "uniform"
    fused_rounds: bool = True      # cohort step (False: per participant)
    participation_rate: float = 1.0  # Poisson cohort subsampling q (only
                                     # the population backend; 1.0 = every
                                     # hospital, every round)
    clipping: str = "auto"         # "auto" | "ghost" | "per-example"
    seed: int = 0
    eval_every: int = 0            # 0 = never (the population backend's)
    max_pad_batch: int | None = None  # static padded per-silo batch
    # systems knobs (bytes also feed the ledger on every backend)
    bytes_per_param: float = 4.0
    fl_server: int = 0             # star hub for fl/fedprox/scaffold/primia
    # gossip-family knobs
    gossip_steps: int | None = None  # local steps per node; None -> rounds
    gossip_every: int = 1            # exchange after every k-th local step


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


def batch_loss_fn(model: Model) -> Callable[[Tree, Tree], torch.Tensor]:
    """``fn(params, {"x": [B, ...], "y": [B]})``: every example's loss under
    ``torch.func.vmap`` of ``model.loss_fn``, as the reference's
    ``jax.vmap`` gives them — a [B] vector."""
    return lambda params, batch: torch.func.vmap(
        lambda ex: model.loss_fn(params, ex))(batch)


def host_batch(batch: dict[str, np.ndarray], device) -> dict:
    """A numpy batch dict as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


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
    goes on the wire (host numpy views for SecAgg, device tensors for the
    simulated transport; None while it stays inside the fused round's
    reduced sum), ``size`` real examples consumed, optional ``loss``."""

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

    Secure aggregation is a backend service: the idealized backend runs
    ``SecAggSession`` over every payload, the simulated-time backend the
    dropout-robust session over the ciphertexts that arrived.  Arms only
    ever say "sum these".  ``fused_reduced`` is the cohort aggregate the
    fused round-step already reduced on the device (None: sum it yourself).
    """

    fused_reduced: Tree | None = None

    def sum_sizes(self, sizes: Sequence[int]) -> int:  # pragma: no cover
        raise NotImplementedError

    def sum_payloads(self, payloads: Mapping[int, Tree]
                     ) -> Tree:  # pragma: no cover
        raise NotImplementedError


# -- arm base classes --------------------------------------------------------


class Arm:
    """Base for all arms.  Subclass ``RoundArm`` or ``NodeArm``, not this."""

    name: str = ""
    mode: str = ""                 # "round" | "node"
    private: bool = False          # has an accountant / nonzero epsilon
    topology_kind: str = "full"    # natural sim topology: full | star | ring

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
    requires_dst_online = False   # star hub must survive the whole round
    void_logs = False             # log a NaN round when nothing aggregates
    empty_break = False           # empty cohort ends the run (vs skipping)
    fused_capable = False         # overrides fused_round
    distributed_noise = False     # DP noise rides per-participant shares, so
                                  # a lost upload under-noises the sum (the
                                  # backend owes a top-up)

    def round_cost(self, i: int) -> int:
        """Expected examples participant ``i`` processes in one round (the
        trace phase's compute-time model; actual draws happen at solve)."""
        return min(self.cfg.batch_size, len(self.participants[i]))

    def clipped_grad_sum_fn(self, pad: int):
        """Model-aware clipped-grad-sum seam (DESIGN.md §12): the ghost path
        for models declaring the capability, the faithful
        ``dp.per_example_clipped_grad_sum`` otherwise — resolved once at arm
        construction so the choice is visible in ``clipping_path``.  Each
        call counts the rows it is handed (counter ``rows.computed``)."""
        from repro_torch.arms import clipping as clipping_lib

        self.clipping_path = clipping_lib.resolve(self.model, self.cfg)
        fn = clipping_lib.clipped_grad_sum_fn(self.model, self.cfg, pad)

        def counted(params, batch, mask):
            obs.counter("rows.computed", mask.shape[0])
            return fn(params, batch, mask)

        return counted

    def planned_rounds(self) -> int:
        """Round cap (e.g. pre-computed epsilon budget)."""
        return self.cfg.rounds

    def quorum(self) -> tuple[int, int | None]:
        """(minimum online nodes, required node index or None) to start."""
        return 1, None

    def participates(self, i: int, t: int) -> bool:
        """Eligibility beyond availability (e.g. local budget exhausted)."""
        return True

    def facilitator(self, t: int, active: Sequence[int]) -> int:
        raise NotImplementedError

    def init_params(self) -> Tree:
        return self.model.init_fn(self.cfg.seed)

    def contribution(self, params: Tree, i: int, t: int,
                     rng: np.random.Generator, n_shares: int
                     ) -> Contribution | None:
        """Participant ``i``'s upload for round ``t`` (None = sits out), a
        device tree: the per-participant path (``fused_rounds=False``).
        The port's cohort step is already a loop over the cohort, so this
        is that step on a cohort of one — the same draws from ``rng``, the
        same numbers, one program call and one host sync per participant.
        """
        contribs, _ = self.fused_round(params, [i], t, rng, n_shares,
                                       payloads="device")
        return contribs.get(i)

    def fused_round(self, params: Tree, active: Sequence[int], t: int,
                    rng: np.random.Generator, n_shares: int,
                    payloads: str | None = None
                    ) -> tuple[dict[int, Contribution], Tree | None]:
        """The cohort-batched round step (DESIGN.md §7): every active
        participant's contribution in ONE program call with ONE host sync.
        Consumes ``rng`` in (round, ascending participant index) order,
        exactly as the ``contribution`` loop would.

        ``payloads`` says what the backend consumes: None, the cohort
        aggregate reduced on the device (each ``payload`` None); "host"
        (SecAgg uploads), every participant's payload brought to the host
        in the same one copy as the losses, as numpy views; "device" (the
        simulated transport), every participant's payload as its own
        device tree.  Neither of the last two returns a reduced sum."""
        raise NotImplementedError

    def aggregate(self, params: Tree, contributions: Mapping[int, Contribution],
                  services: AggregationServices) -> RoundOutcome:
        raise NotImplementedError

    def account(self) -> None:
        """Advance the accountant after a stepped round (no-op by default)."""


class NodeArm(Arm):
    """Per-node arm: independent models, local steps, optional gossip mixing.

    The backend drives the step loop (lockstep when idealized, event-ordered
    under simulated time) and performs the pairwise model averaging; the arm
    owns the local update and the exchange cadence/peer choice.
    """

    mode = "node"
    topology_kind = "ring"

    def steps_total(self) -> int:
        return self.cfg.gossip_steps or self.cfg.rounds

    def step_cost(self, i: int) -> int:
        """Examples one local step processes (sim compute-time model)."""
        return min(self.cfg.batch_size, len(self.participants[i]))

    def init_node_params(self, i: int) -> Tree:
        raise NotImplementedError

    def local_step(self, i: int, params_i: Tree, s: int
                   ) -> tuple[Tree, torch.Tensor, int] | None:
        """One local step: (new params, loss as a 0-d device tensor, examples)
        or None = retired.  The loss stays on the device: the backend syncs
        a lockstep's losses once, or never (simulated time)."""
        raise NotImplementedError

    def wants_exchange(self, i: int, steps_done: int) -> bool:
        return False

    def select_peer(self, i: int, neighbors: Sequence[int]) -> int | None:
        return None

    def consensus(self, per_node_params: list[Tree]
                  ) -> tuple[Tree, list[Tree]]:
        """(headline params, per-node params) once every node finished."""
        return per_node_params[0], per_node_params

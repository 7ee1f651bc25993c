"""DeCaPH — the paper's framework, Steps 1-7, as a registered arm.

Counterpart of ``repro.arms.decaph``: shared Poisson rate, per-example
clipping (ghost clipping for models that declare it), per-participant
noise shares sized so the **sum** carries N(0, (C sigma)^2), SecAgg over
the noised shares and the batch sizes (``use_secagg``, the default),
rotating facilitator, one shared RDP accountant over the aggregate
dataset.

The reference ``vmap``s one participant's step over the cohort; the port
loops over the cohort inside one ``instrumented`` cohort step (the
clipped-sum kernels cannot be vmapped), keeping one program call per
fused round.  The loop lets each slot's clipped sum run on the rows its
Poisson draw holds rather than on the cohort's padded shape: pad rows
add exactly zero to every sum, so the numbers are the padded step's.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

import repro_torch.obs as obs
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
from repro_torch.tree import tree_device, tree_map

# The reference's noise salt, 17: it seeds participant i's round-t noise
# generator from (seed, 17 + t, i) as the reference folds (17 + t, i) into
# its key.  These are SeedSequence words, not JAX fold_in salts, so they
# share no key namespace with the reference's _NOISE_SALT.
_NOISE_STREAM = 17


@register("decaph")
class DeCaPHArm(RoundArm):
    """The DeCaPH protocol (distributed-noise DP-SGD behind SecAgg)."""

    private = True
    secure_uploads = True
    void_logs = True            # an empty Poisson round is logged as NaN
    topology_kind = "full"      # any participant can facilitate
    fused_capable = True
    distributed_noise = True    # per-participant noise shares sum to (Cσ)²

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

    def quorum(self) -> tuple[int, int | None]:
        # running below the configured reconstruction threshold would
        # silently weaken the operator's security choice
        if self.cfg.use_secagg:
            return max(2, self.cfg.secagg_threshold or 2), None
        return 2, None

    def round_cost(self, i: int) -> int:
        # expected Poisson draw, not the full batch: at H=1000 a hospital
        # contributes rate * |shard| examples per round in expectation
        return max(1, int(round(self.rate * len(self.participants[i]))))

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

    def _chunk(self, pad_to: int) -> int | None:
        """The ghost chunk a slot of ``pad_to`` rows runs in; None where it
        runs in one piece, or clips per example."""
        chunk = self.model.ghost.chunk_size \
            if self.clipping_path == "ghost" else None
        return chunk if chunk and chunk < pad_to and pad_to % chunk == 0 \
            else None

    def _slot_rows(self, k: int, pad_to: int) -> int:
        """How many of a slot's ``pad_to`` rows (real rows first) its clip
        function is handed for a draw of ``k``: all of them where a mesh
        executor needs them (``fused.padded_slots``); else the draw's own,
        rounded up to whole ghost chunks where a chunk divides the pad, so
        the chunk still bounds the passes' memory (a batch no chunk
        divides runs in one piece)."""
        if fused.padded_slots():
            return pad_to
        chunk = self._chunk(pad_to)
        return k if chunk is None else -(-k // chunk) * chunk

    def _nothing_clipped(self, params, pad_to: int):
        """A slot with no rows to clip: the zero sum in the dtypes its
        padded rows would have given (one ghost piece: each parameter's
        own; chunks and per-example clipping accumulate in float32), and
        the loss of an empty draw, 0."""
        one_piece = (self.clipping_path == "ghost"
                     and self._chunk(pad_to) is None)
        dtype = None if one_piece else torch.float32
        zero = tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)
        return zero, torch.zeros((), dtype=torch.float32,
                                 device=tree_device(params))

    def _cohort_step(self, params, bx, by, masks, counts, t, active,
                     n_shares, payloads=None):
        """Every participant's noised clipped sum (with ``payloads``) or
        else their cohort total in ascending-slot order, and every
        participant's loss; the one not returned is None.  ``counts`` are
        the slots' real rows (host ints), which bound what each slot
        clips; a slot that drew none clips nothing and still draws its
        noise share."""
        device = tree_device(params)
        pad_to = masks.shape[1]
        stack, losses = [], []
        for s in fused.cohort_slots(len(active)):
            with obs.span("clip", cat="dp", device_time=True, slot=s,
                          hospital=active[s], t=t):
                rows = self._slot_rows(counts[s], pad_to)
                if rows:
                    g_sum, loss = self._clip_fn(
                        params, {"x": bx[s][:rows], "y": by[s][:rows]},
                        masks[s][:rows])
                else:
                    obs.counter("clip.empty_slots")
                    g_sum, loss = self._nothing_clipped(params, pad_to)
            with obs.span("dp.noise", cat="dp", device_time=True, slot=s):
                stack.append(self._noised(g_sum, t, active[s], n_shares,
                                          device))
            losses.append(loss)
        with obs.span("fused.reduce", cat="train", device_time=True):
            stack = fused.gather_slots(stack, len(active))
            losses = fused.gather_slots(losses, len(active))
            if payloads:
                return stack, None, torch.stack(losses)
            return None, fused.seq_tree_sum(stack), torch.stack(losses)

    def fused_round(self, params, active, t, rng, n_shares, payloads=None):
        cb = fused.stack_poisson(rng, self.participants, active, self.rate,
                                 self.pad)
        stack, reduced, losses = self._fused_step(
            params, *fused.to_device(cb, tree_device(params)),
            cb.counts.tolist(), t, list(active), n_shares, payloads)
        return fused.build_contributions(active, losses, cb.sizes, stack,
                                         payloads), reduced

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

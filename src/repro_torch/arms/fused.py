"""The fused cohort round-step: one program call per round (DESIGN.md §7).

Counterpart of ``repro.arms.fused``.  The reference stacks the cohort's
padded Poisson batches on a participant axis and ``vmap``s the arm's
per-silo numerics across it inside ONE jitted program.  A hand-written
kernel cannot be vmapped, so the port's cohort step loops over the cohort
inside one ``instrumented`` call: still one program call and one host
sync per round (the stacked losses, and with SecAgg the cohort's payloads
in the same copy).

Contract, as in the reference:

  * ``stack_poisson`` consumes the host rng in (round, ascending
    participant index) order, so its Poisson draws are the reference's,
    number for number;
  * ``seq_tree_sum`` / ``seq_weighted_sum`` reduce the cohort in
    ascending-slot order on the device, so the ideal backend's fused total
    and the simulated backend's sum of delivered payloads agree bit for
    bit.

The executor seam (the reference's ``execution_context`` /
``active_executor``, from ``repro_torch.instrument``): under a mesh
executor (the ``shard`` backend) ``stack_poisson`` rounds the cohort pad
up with ``executor.round_pad`` and ``mark``s the stacked arrays,
``to_device`` keeps this rank's part of each, and the cohort steps run
their slots through four hooks: ``cohort_slots`` (the slots this rank
computes), ``gather_slots`` (every slot's result, in slot order),
``example_sum`` (a sum over a slot's examples, summed over the ranks that
split them) and ``padded_slots`` (whether the slots must keep their
pad).  Without an executor each hook is the identity, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.arms.base import (
    Contribution,
    Participant,
    poisson_batch,
    tree_sum,
)
from repro_torch.instrument import (  # noqa: F401  (re-exported)
    active_executor,
    execution_context,
    instrumented,
    jit_dispatches,
    reset_jit_dispatches,
)
from repro_torch.tree import Tree, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class CohortBatch:
    """The active cohort's Poisson draws, stacked to one static shape.

    ``x``/``y``/``masks`` have leading axis ``n_active`` (plus a steps axis
    when ``steps`` was requested); ``counts`` is each draw's real-example
    count (int32, the same leading axes); ``sizes`` is each participant's
    total, as host ints.
    """

    x: np.ndarray
    y: np.ndarray
    masks: np.ndarray
    counts: np.ndarray
    sizes: list[int]


def _repad(arr: np.ndarray, pad_to: int) -> np.ndarray:
    if arr.shape[0] == pad_to:
        return arr
    out = np.zeros((pad_to,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def stack_poisson(rng: np.random.Generator,
                  participants: Sequence[Participant],
                  active: Sequence[int], rate: float | Sequence[float],
                  pad: int | Sequence[int], steps: int | None = None
                  ) -> CohortBatch:
    """Stack each active participant's Poisson draw(s) to one static shape.

    Consumes ``rng`` in exactly the order the per-participant loop would:
    ascending participant index, and (with ``steps``) each participant's
    local steps drawn consecutively.  ``rate``/``pad`` may be sequences
    indexed by absolute participant index (primia: every client has its
    own rate and pad); each draw uses its own, and every row is re-padded
    to the cohort's max, as is the whole cohort when a draw outgrew its
    pad (``poisson_batch`` grows rather than truncates).  Masks keep the
    extra rows inert.

    Under a mesh executor the pad is rounded up to the mesh's data extent
    (again mask-inert) and the stacked batch arrays are marked for
    splitting.
    """
    t0 = obs.now()  # host-RNG phase: the one per-round host-side cost
    rate_of = ((lambda i: rate) if isinstance(rate, (int, float))
               else rate.__getitem__)
    pad_of = (lambda i: pad) if isinstance(pad, int) else pad.__getitem__
    k_steps = 1 if steps is None else steps
    draws = [[poisson_batch(rng, participants[i], rate_of(i), pad_of(i))
              for _ in range(k_steps)] for i in active]
    pad_to = max([pad_of(i) for i in active]
                 + [len(d[1]) for row in draws for d in row])
    executor = active_executor()
    if executor is not None:
        pad_to = executor.round_pad(pad_to)

    def gather(fn):
        return np.stack([np.stack([fn(d) for d in row]) for row in draws])

    x = gather(lambda d: _repad(d[0]["x"], pad_to))
    y = gather(lambda d: _repad(d[0]["y"], pad_to))
    masks = gather(lambda d: _repad(d[1], pad_to))
    counts = np.asarray([[d[2] for d in row] for row in draws], np.int32)
    sizes = [int(c) for c in counts.sum(axis=1)]
    if steps is None:  # collapse the singleton steps axis
        x, y, masks, counts = x[:, 0], y[:, 0], masks[:, 0], counts[:, 0]
    if executor is not None:
        for arr in (x, y, masks):
            executor.mark(arr, axis=1 if steps is None else 2)
    obs.complete("host_rng.stack_poisson", t0, cat="rng",
                 cohort=len(active), pad=pad_to)
    # rows drawn; the rows computed are counted where they enter the clip
    # function (``RoundArm.clipped_grad_sum_fn``)
    obs.counter("rows.real", sum(sizes))
    return CohortBatch(x=x, y=y, masks=masks, counts=counts, sizes=sizes)


def to_device(cb: CohortBatch, device) -> tuple[torch.Tensor, ...]:
    """``x``, ``y`` and ``masks`` of ``cb`` as tensors on ``device`` (under
    a mesh executor, this rank's part of each)."""
    executor = active_executor()
    local = (lambda a: a) if executor is None else executor.local_rows
    with obs.span("fused.to_device", cat="train", device_time=True):
        return tuple(torch.from_numpy(local(a)).to(device)
                     for a in (cb.x, cb.y, cb.masks))


# -- the mesh hooks of the cohort steps --------------------------------------


def cohort_slots(n: int) -> Sequence[int]:
    """The cohort slots of ``n`` this rank computes: all of them, unless a
    mesh executor splits the participant axis."""
    executor = active_executor()
    return range(n) if executor is None else executor.slots(n)


def gather_slots(results: list, n: int) -> list:
    """Every slot's result in slot order, from this rank's ``results`` for
    ``cohort_slots(n)`` (each a tree of tensors)."""
    executor = active_executor()
    return results if executor is None else executor.gather_slots(results, n)


def example_sum(tree):
    """A sum over one slot's examples (a tree of tensors): summed over the
    ranks that split the examples, made whole where it is a DTensor."""
    executor = active_executor()
    return tree if executor is None else executor.example_sum(tree)


def padded_slots() -> bool:
    """Whether a mesh executor needs every slot's padded rows
    (``MeshExecutor.pads_slots``); else each slot this rank computes is
    whole on it, real rows first, and may run on those alone."""
    executor = active_executor()
    return executor is not None and executor.pads_slots()


# -- the cohort reductions on the device -------------------------------------
#
# The port's cohort stack is a list of trees, one per participant slot, so
# both reductions are left folds in ascending slot order on the stack's
# device and in its dtype: the ideal backend's fused total and the
# simulated backend's sum of the delivered payloads are the same adds in
# the same order, bit for bit.  Neither is ``torch.sum`` over a stacked
# dimension, which may reorder the adds.


def seq_tree_sum(stack: Sequence[Tree]) -> Tree:
    """``stack[0] + stack[1] + ...``, in ascending slot order."""
    return tree_sum(stack)


def seq_weighted_sum(stack: Sequence[Tree], weights: Sequence[float]
                     ) -> Tree:
    """``w[0] * stack[0] + w[1] * stack[1] + ...`` in ascending slot order
    (the size-weighted FedAvg average); ``weights`` are Python floats
    (float32 values, as the reference's weights are)."""
    total = tree_map(lambda x: weights[0] * x, stack[0])
    for w, tree in zip(weights[1:], stack[1:]):
        total = tree_map(lambda a, x, w=w: a + w * x, total, tree)
    return total


def fedavg_weights(sizes: Sequence[float]) -> list[float]:
    """``size / sum(sizes)`` per slot, rounded to float32 like the
    reference's ``np.float32`` weights."""
    wsum = sum(sizes)
    return np.asarray([w / wsum for w in sizes], np.float32).tolist()


# -- fused output -> per-participant contributions ---------------------------


def _host_rows(payloads: Sequence[Tree], losses: torch.Tensor | None
               ) -> tuple[list[Tree], np.ndarray | None]:
    """The cohort's payload trees and losses in ONE device-to-host copy.

    On the device, each tree is flattened into one float32 row and the rows
    are stacked into [n_active, L + 1] with each participant's loss in the
    last column (no column without losses); after the one ``.cpu()``, every
    payload leaf is a numpy view of its row.
    """
    rows = torch.stack([
        torch.cat([leaf.detach().reshape(-1).float()
                   for leaf in tree_leaves(tree)]
                  + ([] if losses is None
                     else [losses[s].detach().float().reshape(1)]))
        for s, tree in enumerate(payloads)
    ])
    with obs.span("fused.sync", cat="train"):
        # repro: allow[host-sync-hygiene] the round's one sync, on build_contributions' SecAgg path: the cohort's payloads and losses in one copy
        host = rows.cpu().numpy()
    views = []
    for row in host:
        leaves, off = [], 0
        for leaf in tree_leaves(payloads[0]):
            leaves.append(row[off:off + leaf.numel()].reshape(leaf.shape))
            off += leaf.numel()
        views.append(tree_unflatten(payloads[0], leaves))
    return views, None if losses is None else host[:, -1]


def build_contributions(active: Sequence[int], losses: torch.Tensor | None,
                        sizes: Sequence[int],
                        payloads: Sequence[Tree] | None = None,
                        mode: str | None = None
                        ) -> dict[int, Contribution]:
    """One host sync for the whole cohort's losses (none for an arm that
    logs no loss) — and, in ``mode`` "host" (SecAgg uploads), for the whole
    cohort's payloads in the same copy; the slices are numpy views.  In
    mode "device" each ``payload`` is its participant's device tree; in
    mode None the payloads stay inside the fused reduced sum and each is
    None.
    """
    loss_vals = None
    if mode == "host":
        slices, loss_vals = _host_rows(payloads, losses)
    else:
        slices = list(payloads) if mode == "device" else [None] * len(active)
        if losses is not None:
            with obs.span("fused.sync", cat="train"):
                loss_vals = losses.detach().cpu().numpy()
    return {
        i: Contribution(
            payload=slices[s],
            size=int(sizes[s]),
            # repro: allow[host-sync-hygiene] loss_vals is host numpy: the one sync per round is .cpu() above, the port's counterpart of the sanctioned repro.arms.fused:build_contributions
            loss=None if loss_vals is None else float(loss_vals[s]),
        )
        for s, i in enumerate(active)
    }

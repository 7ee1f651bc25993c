"""The fused cohort round-step: one program call per round (DESIGN.md §7).

Counterpart of ``repro.arms.fused``.  The reference stacks the cohort's
padded Poisson batches on a participant axis and ``vmap``s the arm's
per-silo numerics across it inside ONE jitted program.  A hand-written
kernel cannot be vmapped, so the port's cohort step loops over the cohort
inside one ``instrumented`` call: still one program call and one host
sync (the stacked losses) per round.

Contract, as in the reference:

  * ``stack_poisson`` consumes the host rng in (round, ascending
    participant index) order, so its Poisson draws are the reference's,
    number for number;
  * ``seq_tree_sum`` reduces the cohort in ascending-slot order, the
    association of the eager ``tree_sum`` over slices.
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
    instrumented,
    jit_dispatches,
    reset_jit_dispatches,
)


@dataclasses.dataclass
class CohortBatch:
    """The active cohort's Poisson draws, stacked to one static shape:
    ``x``/``y``/``masks`` with leading axis ``n_active``, and ``sizes``,
    the real examples of each draw as host ints."""

    x: np.ndarray
    y: np.ndarray
    masks: np.ndarray
    sizes: list[int]


def _repad(arr: np.ndarray, pad_to: int) -> np.ndarray:
    if arr.shape[0] == pad_to:
        return arr
    out = np.zeros((pad_to,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def stack_poisson(rng: np.random.Generator,
                  participants: Sequence[Participant],
                  active: Sequence[int], rate: float, pad: int
                  ) -> CohortBatch:
    """Stack each active participant's Poisson draw to one static shape.

    Consumes ``rng`` in ascending participant index.  If any draw outgrew
    the pad (``poisson_batch`` grows rather than truncates), the whole
    cohort is re-padded to the round's max; masks keep the extra rows
    inert.
    """
    t0 = obs.now()  # host-RNG phase: the one per-round host-side cost
    draws = [poisson_batch(rng, participants[i], rate, pad) for i in active]
    pad_to = max([pad] + [len(m) for _, m, _ in draws])
    x = np.stack([_repad(b["x"], pad_to) for b, _, _ in draws])
    y = np.stack([_repad(b["y"], pad_to) for b, _, _ in draws])
    masks = np.stack([_repad(m, pad_to) for _, m, _ in draws])
    obs.complete("host_rng.stack_poisson", t0, cat="rng",
                 cohort=len(active), pad=pad_to)
    return CohortBatch(x=x, y=y, masks=masks,
                       sizes=[int(k) for _, _, k in draws])


# The port's cohort stack is a list of trees, so the in-program reduction is
# the eager ascending-order sum itself: bit for bit the sum a backend would
# take over delivered slices.
seq_tree_sum = tree_sum


def build_contributions(active: Sequence[int], losses: torch.Tensor,
                        sizes: Sequence[int]) -> dict[int, Contribution]:
    """One host sync for the whole cohort's losses.  The payloads stay on
    the device inside the reduced sum, so each ``Contribution.payload`` is
    None."""
    loss_vals = losses.detach().cpu().numpy()
    return {
        i: Contribution(
            payload=None,
            size=int(sizes[s]),
            # repro: allow[host-sync-hygiene] loss_vals is host numpy: the one sync per round is .cpu() above, the port's counterpart of the sanctioned repro.arms.fused:build_contributions
            loss=float(loss_vals[s]),
        )
        for s, i in enumerate(active)
    }

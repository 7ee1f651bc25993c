"""The comparison that decides ``correct``: each number with its limit.

Training (``train_numbers``): the program's first steps against the plain
reference's, as the optimizer sees them.

  * ``agg_mismatch`` — rounds whose aggregate batch differs from the
    protocol's draw (exact: limit 0);
  * ``loss_gap`` — the worst round's |program - reference| / reference
    loss;
  * ``grad_gap`` — round 0's gradient as the optimizer got it, worked out
    from the weights ((before - after) / lr, less the noise the reference
    drew again): the worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf;
  * ``change_gap`` — the same for the change of the weights over the
    first rounds, less their noise;
  * ``last_loss_gap``, ``last_grad_gap`` — the loss and the gradient of
    the window's last round, which the reference follows from the
    program's weights as they were before it (the rounds before the
    window run in set-up, so its rounds are checked here).
    ``agg_mismatch`` counts that round too.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both gaps.
"""

from __future__ import annotations

import math
import statistics

import torch

KEEP_BELOW_MEDIAN = 1e-3


def _norm64(t: torch.Tensor) -> float:
    return float(t.double().norm())


def program_steps(p0: list[torch.Tensor], p1: list[torch.Tensor],
                  p_last: list[torch.Tensor], ref: dict, lr: float) -> dict:
    """The program's per-leaf norms of its first gradient and of its
    change, from its weights before, after round 0 and after the last
    followed round, with the reference's noise taken out (in float64)."""
    grad1, change = [], []
    for a, b, c, n1, nc in zip(p0, p1, p_last, ref["noise1"],
                               ref["noise_change"]):
        a64 = a.double()
        grad1.append(_norm64((a64 - b.double()) / lr - n1.double()))
        change.append(_norm64(c.double() - a64 + nc.double()))
    return {"grad1": grad1, "change": change}


def _leaf_gap(prog: list[float], ref: list[float]) -> float:
    med = statistics.median(ref)
    kept = [(p, r) for p, r in zip(prog, ref) if r >= KEEP_BELOW_MEDIAN * med]
    return max(abs(p - r) / max(r, med) for p, r in kept)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref`` each hold ``loss`` and ``agg`` per round and
    ``grad1`` and ``change`` per leaf."""
    n = len(ref["loss"])
    return {
        "agg_mismatch": float(sum(a != b for a, b in
                                  zip(prog["agg"][:n], ref["agg"]))),
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["loss"][:n], ref["loss"])),
        # a round 0 that steps on neither side or on one only reads inf
        "grad_gap": (_leaf_gap(prog["grad1"], ref["grad1"])
                     if "grad1" in prog and "grad1" in ref else math.inf),
        "change_gap": _leaf_gap(prog["change"], ref["change"]),
    }


def last_round_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The window's last round: ``prog`` and ``ref`` as for
    ``train_numbers``, over that one round."""
    n = train_numbers(prog, ref)
    return {"agg_mismatch": n["agg_mismatch"],
            "last_loss_gap": n["loss_gap"], "last_grad_gap": n["grad_gap"]}


def all_numbers(first: dict[str, float], last: dict[str, float]
                ) -> dict[str, float]:
    """The first rounds' numbers and the last round's, one
    ``agg_mismatch`` over both."""
    return {**first, **last,
            "agg_mismatch": first["agg_mismatch"] + last["agg_mismatch"]}


def judge(numbers: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """Every number at or under its limit (a NaN is over), and the numbers
    beside their limits."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(numbers[k] <= limits[k] for k in limits)
    return ok, shown

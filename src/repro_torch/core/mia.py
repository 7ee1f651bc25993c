"""Membership inference via the Likelihood Ratio Attack (LiRA, Carlini 2022).

The port's numpy copy of ``repro.core.mia``: the attack sees only the
callers' ``train_fn`` and ``confidence_fn``, so the shadows and targets
train wherever those put them (on the card, in ``chip_smoke.py``).

Used as the paper's empirical privacy audit (Fig. 5): the online attack
trains N shadow models on random half-splits, fits per-example Gaussians to
the scaled confidences of IN and OUT shadows, and scores the target model's
examples by the likelihood ratio.  The headline comparison is AUROC (and
TPR at low FPR) of the attack against FL-trained vs DeCaPH-trained targets.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


def _logit_scale(p: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    p = np.clip(p, eps, 1 - eps)
    return np.log(p) - np.log(1 - p)


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUROC (no sklearn)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[labels.astype(bool)].sum() - n_pos * (n_pos + 1) / 2)
        / (n_pos * n_neg)
    )


def roc_curve(scores: np.ndarray, labels: np.ndarray, n_points: int = 200):
    thresholds = np.quantile(scores, np.linspace(0, 1, n_points))
    tpr, fpr = [], []
    pos = labels.astype(bool)
    for t in thresholds[::-1]:
        pred = scores >= t
        tpr.append((pred & pos).sum() / max(pos.sum(), 1))
        fpr.append((pred & ~pos).sum() / max((~pos).sum(), 1))
    return np.asarray(fpr), np.asarray(tpr)


def tpr_at_fpr(scores, labels, target_fpr: float = 0.01) -> float:
    fpr, tpr = roc_curve(scores, labels, n_points=500)
    ok = fpr <= target_fpr
    return float(tpr[ok].max()) if ok.any() else 0.0


@dataclasses.dataclass
class LiRAResult:
    scores: np.ndarray
    membership: np.ndarray
    auroc: float
    tpr_at_1pct_fpr: float


def lira_attack(
    train_fn: Callable[[np.ndarray, np.ndarray, int], object],
    confidence_fn: Callable[[object, np.ndarray, np.ndarray], np.ndarray],
    x: np.ndarray,
    y: np.ndarray,
    *,
    n_shadows: int = 16,
    seed: int = 0,
    target_seed: int = 999,
) -> LiRAResult:
    """Online LiRA.

    train_fn(x_train, y_train, seed) -> model; confidence_fn(model, x, y) ->
    per-example probability assigned to the true label.  The target model is
    trained on a random half split (seed ``target_seed``); its training half
    forms the members.
    """
    rng = np.random.default_rng(seed)
    n = len(x)
    # shadow in/out masks: each example is IN for ~half the shadows
    in_masks = rng.random((n_shadows, n)) < 0.5
    phi = np.zeros((n_shadows, n), np.float64)
    for s in range(n_shadows):
        m = in_masks[s]
        model = train_fn(x[m], y[m], seed + 100 + s)
        phi[s] = _logit_scale(np.asarray(confidence_fn(model, x, y)))

    mu_in = np.zeros(n)
    mu_out = np.zeros(n)
    sd_in = np.ones(n)
    sd_out = np.ones(n)
    for i in range(n):
        pin = phi[in_masks[:, i], i]
        pout = phi[~in_masks[:, i], i]
        if len(pin) >= 2:
            mu_in[i], sd_in[i] = pin.mean(), max(pin.std(), 1e-3)
        if len(pout) >= 2:
            mu_out[i], sd_out[i] = pout.mean(), max(pout.std(), 1e-3)

    t_rng = np.random.default_rng(target_seed)
    member = t_rng.random(n) < 0.5
    target = train_fn(x[member], y[member], target_seed)
    phi_t = _logit_scale(np.asarray(confidence_fn(target, x, y)))

    def log_norm(v, mu, sd):
        return -0.5 * ((v - mu) / sd) ** 2 - np.log(sd)

    scores = log_norm(phi_t, mu_in, sd_in) - log_norm(phi_t, mu_out, sd_out)
    return LiRAResult(
        scores=scores,
        membership=member.astype(np.int32),
        auroc=auroc(scores, member.astype(np.int32)),
        tpr_at_1pct_fpr=tpr_at_fpr(scores, member.astype(np.int32), 0.01),
    )

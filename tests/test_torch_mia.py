"""The port's LiRA audit (``repro_torch.core.mia``) against the reference.

A numpy copy: ``auroc``, ``roc_curve`` and ``tpr_at_fpr`` give the
reference's numbers bit for bit on seeded scores (ties, one class only,
tiny and large inputs), and ``lira_attack`` with the same deterministic
numpy ``train_fn`` and ``confidence_fn`` gives the reference's scores,
membership, AUROC and TPR at 1% FPR exactly.
"""

import numpy as np
import pytest

from repro.core import mia as jmia
from repro_torch.core import mia


@pytest.mark.parametrize("n,seed,ties", [(2, 0, False), (50, 1, False),
                                         (400, 2, True), (3001, 3, True)])
def test_roc_metrics_are_the_references(n, seed, ties):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.4).astype(np.int32)
    scores = rng.normal(labels * 0.7, 1.0)
    if ties:
        scores = np.round(scores, 1)
    assert mia.auroc(scores, labels) == jmia.auroc(scores, labels)
    for pts in (5, 200):
        f1, t1 = mia.roc_curve(scores, labels, n_points=pts)
        f2, t2 = jmia.roc_curve(scores, labels, n_points=pts)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(t1, t2)
    for target in (0.0, 0.01, 0.1):
        assert mia.tpr_at_fpr(scores, labels, target) == \
            jmia.tpr_at_fpr(scores, labels, target)


def test_one_class_only_is_chance():
    s = np.arange(5.0)
    for lab in (np.zeros(5, np.int32), np.ones(5, np.int32)):
        assert mia.auroc(s, lab) == jmia.auroc(s, lab) == 0.5


def _train(x, y, seed):
    """Ridge-like least squares on the members, nudged by the seed — a
    deterministic numpy 'model' that remembers its training set."""
    rng = np.random.default_rng(seed)
    xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    w = np.linalg.solve(xb.T @ xb + 0.1 * np.eye(xb.shape[1]),
                        xb.T @ (2.0 * y - 1.0))
    return w + rng.normal(0.0, 1e-3, w.shape)


def _confidence(w, x, y):
    xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    p1 = 1.0 / (1.0 + np.exp(-3.0 * (xb @ w)))
    return np.where(y > 0.5, p1, 1.0 - p1)


@pytest.mark.parametrize("n_shadows,seed", [(2, 0), (8, 1), (16, 5)])
def test_lira_scores_are_the_references(n_shadows, seed):
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(size=(120, 12))
    y = (x[:, 0] + 0.5 * rng.normal(size=120) > 0).astype(np.float64)
    kw = dict(n_shadows=n_shadows, seed=seed, target_seed=999 + seed)
    ours = mia.lira_attack(_train, _confidence, x, y, **kw)
    ref = jmia.lira_attack(_train, _confidence, x, y, **kw)
    np.testing.assert_array_equal(ours.scores, ref.scores)
    np.testing.assert_array_equal(ours.membership, ref.membership)
    assert ours.auroc == ref.auroc and 0.0 <= ours.auroc <= 1.0
    assert ours.tpr_at_1pct_fpr == ref.tpr_at_1pct_fpr
    assert ours.membership.dtype == np.int32

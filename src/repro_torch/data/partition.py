"""Silo partitioners for turning a pooled dataset into participants.

The port's copy of ``repro.data.partition`` (numpy only, the same draws).
"""

from __future__ import annotations

import numpy as np

from repro_torch.arms.base import Participant


def sized_partition(x, y, proportions, seed: int = 0) -> list[Participant]:
    """Random partition with given size proportions."""
    rng = np.random.default_rng(seed)
    n = len(x)
    idx = rng.permutation(n)
    props = np.asarray(proportions, np.float64)
    props = props / props.sum()
    bounds = np.floor(np.cumsum(props) * n).astype(int)
    out, start = [], 0
    for b in bounds:
        sel = idx[start:b]
        out.append(Participant(x[sel], y[sel]))
        start = b
    return out


def dirichlet_partition(x, y, n_silos: int, alpha: float = 0.5,
                        seed: int = 0, n_classes: int | None = None
                        ) -> list[Participant]:
    """Label-skewed (non-IID) partition via per-class Dirichlet shares."""
    rng = np.random.default_rng(seed)
    y_int = y.astype(int) if y.ndim == 1 else y.argmax(-1).astype(int)
    classes = np.unique(y_int) if n_classes is None else np.arange(n_classes)
    silo_idx: list[list[int]] = [[] for _ in range(n_silos)]
    for c in classes:
        rows = np.nonzero(y_int == c)[0]
        rng.shuffle(rows)
        shares = rng.dirichlet(alpha * np.ones(n_silos))
        bounds = np.floor(np.cumsum(shares) * len(rows)).astype(int)
        bounds[-1] = len(rows)  # rounding must not drop examples
        start = 0
        for s, b in enumerate(bounds):
            silo_idx[s].extend(rows[start:b].tolist())
            start = b
    return [
        Participant(x[np.asarray(ix, int)], y[np.asarray(ix, int)])
        for ix in silo_idx
        if len(ix) > 0
    ]


def train_test_split_silos(silos, test_frac: float = 0.2, seed: int = 0):
    """Per-silo split (paper: 20% of each participant's data is test)."""
    rng = np.random.default_rng(seed)
    train, test_x, test_y = [], [], []
    for p in silos:
        idx = rng.permutation(len(p))
        k = int(len(p) * (1 - test_frac))
        train.append(Participant(p.x[idx[:k]], p.y[idx[:k]]))
        test_x.append(p.x[idx[k:]])
        test_y.append(p.y[idx[k:]])
    return train, np.concatenate(test_x), np.concatenate(test_y)

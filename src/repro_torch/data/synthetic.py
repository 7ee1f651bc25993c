"""Synthetic multi-silo datasets matching the paper's published statistics.

GEMINI EHR and the PhysioNet X-ray sets are access-gated (paper Data Sharing
section), so the reproduction uses synthetic generators engineered to match
the *published* dimensions, silo counts, silo-size skews, class imbalance and
inter-silo covariate shift — everything the framework's behaviour depends on.
DESIGN.md §2 records this substitution.

  * GEMINI-like: 436 features (categorical one-hot + numeric), 8 silos with
    the paper's heavy size skew, ~17% mortality rate, per-silo covariate shift.
  * Pancreas-like: 15,558 gene-count features (log1p), 5 silos (one tiny, as
    Wang is in the paper), 4 cell types, strong class signal.
  * X-ray-like: [H, W, 1] images, 3 silos, 4 multi-label outputs with
    label-dependent structured patterns.
  * LM stream: token sequences from a deterministic mixture process for the
    pod-scale training driver.

The port's copy of ``repro.data.synthetic``: numpy only, every array the
reference's bit for bit for the same arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.arms.base import Participant


def _silo_props(published: "np.ndarray", n_silos: int) -> "np.ndarray":
    """Per-silo size proportions for any cohort size.

    Up to the published count the paper's proportions are used verbatim
    (same silo sizes as before for any given seed); beyond it the tail
    decays geometrically from the smallest published silo — capacity sweeps
    run H=10/20 cohorts the papers never enumerated.  Always renormalised
    to sum to 1.
    """
    if n_silos <= len(published):
        props = published[:n_silos]
    else:
        tail = published.min() * 0.8 ** np.arange(
            1, n_silos - len(published) + 1
        )
        props = np.concatenate([published, tail])
    return props / props.sum()


def _latent_binary_task(rng, n, d_feat, d_latent, w_scale=1.0):
    """Linear-logit ground truth in a latent space + nuisance dims."""
    w = rng.normal(0, w_scale, d_latent)
    proj = rng.normal(0, 1.0 / np.sqrt(d_latent), (d_latent, d_feat))
    z = rng.normal(0, 1, (n, d_latent))
    logits = z @ w
    y = (logits + rng.logistic(0, 1, n) > 0).astype(np.float32)
    x = z @ proj + rng.normal(0, 0.5, (n, d_feat))
    return x.astype(np.float32), y, (w, proj)


def make_gemini_like(
    seed: int = 0,
    n_total: int = 40114 // 8,   # scaled-down default; pass full for paper runs
    n_silos: int = 8,
    n_features: int = 436,
    mortality_rate: float = 0.17,
) -> list[Participant]:
    """8-hospital EHR-like binary mortality task with silo skew + shift."""
    rng = np.random.default_rng(seed)
    # Paper Fig 2a: hospital sizes are heavily skewed.
    props = _silo_props(
        np.array([0.22, 0.18, 0.15, 0.12, 0.10, 0.09, 0.08, 0.06]), n_silos
    )
    d_latent = 24
    shift_std = 0.8
    w = rng.normal(0, 1.2, d_latent)
    proj = rng.normal(0, 1.0 / np.sqrt(d_latent), (d_latent, n_features))
    # marginal z variance includes the inter-silo shift component
    bias = _solve_rate_bias(rng, w, d_latent, mortality_rate,
                            z_std=float(np.sqrt(1.0 + shift_std**2)))
    silos = []
    for i in range(n_silos):
        n = max(16, int(n_total * props[i]))
        # inter-hospital case-mix shift: calibrated so silo-local models
        # generalise poorly to the pooled test set (paper Fig 2c shows
        # per-hospital AUROC ~0.5) while collaborative models don't.
        shift = rng.normal(0, shift_std, d_latent)
        z = rng.normal(0, 1, (n, d_latent)) + shift
        logits = z @ w + bias
        y = (logits + rng.logistic(0, 1, n) > 0).astype(np.float32)
        x = z @ proj + rng.normal(0, 0.5, (n, n_features))
        # ~half the features behave like one-hot categoricals
        n_cat = n_features // 2
        x[:, :n_cat] = (x[:, :n_cat] > 0.8).astype(np.float32)
        silos.append(Participant(x.astype(np.float32), y))
    return silos


def _solve_rate_bias(rng, w, d_latent, rate, z_std=1.0, n_probe=20000):
    z = rng.normal(0, z_std, (n_probe, d_latent))
    logits = np.sort(z @ w)
    return -logits[int((1 - rate) * n_probe)]


def make_pancreas_like(
    seed: int = 0,
    n_total: int = 10548 // 4,
    n_silos: int = 5,
    n_genes: int = 15558,
    n_types: int = 4,
) -> list[Participant]:
    """5-study scRNA-like 4-class task; silo 4 tiny (paper's Wang study)."""
    rng = np.random.default_rng(seed)
    props = _silo_props(np.array([0.55, 0.20, 0.13, 0.02, 0.10]), n_silos)
    # informative genes per type (marker genes)
    n_marker = 120
    markers = rng.choice(n_genes, (n_types, n_marker), replace=True)
    class_probs = np.array([0.45, 0.35, 0.07, 0.13])[:n_types]
    class_probs = class_probs / class_probs.sum()
    silos = []
    for i in range(n_silos):
        n = max(24, int(n_total * props[i]))
        y = rng.choice(n_types, n, p=class_probs)
        base = rng.poisson(0.3, (n, n_genes)).astype(np.float32)
        batch_effect = rng.normal(0, 0.15, n_genes)   # study batch effect
        for c in range(n_types):
            rows = y == c
            base[np.ix_(rows, markers[c])] += rng.poisson(
                6.0, (rows.sum(), n_marker)
            )
        x = np.log10(base + 1.0) + batch_effect
        silos.append(Participant(x.astype(np.float32), y.astype(np.int32)))
    return silos


def make_xray_like(
    seed: int = 0,
    n_total: int = 1800,
    n_silos: int = 3,
    image_size: int = 32,
) -> list[Participant]:
    """3-study image task, 4 multilabel outputs with structured patterns."""
    rng = np.random.default_rng(seed)
    props = _silo_props(np.array([0.31, 0.24, 0.45]), n_silos)
    silos = []
    hw = image_size
    for i in range(n_silos):
        n = max(32, int(n_total * props[i]))
        has = rng.random((n, 3)) < np.array([0.18, 0.22, 0.12])
        no_finding = ~has.any(axis=1)
        y = np.concatenate([has, no_finding[:, None]], axis=1).astype(np.float32)
        x = rng.normal(0.45 + 0.05 * i, 0.18, (n, hw, hw, 1))  # silo intensity shift
        yy, xx = np.mgrid[0:hw, 0:hw] / hw
        for j in range(n):
            if has[j, 0]:  # "atelectasis": horizontal band in the upper half
                r = rng.integers(hw // 8, hw // 2)
                x[j, r - 1 : r + 2, :, 0] += 1.2
            if has[j, 1]:  # "effusion": bright lower wedge
                x[j, int(0.7 * hw) :, :, 0] += 1.0 * xx[int(0.7 * hw) :, :]
            if has[j, 2]:  # "cardiomegaly": strong central blob
                cx, cy = 0.5 + 0.05 * rng.standard_normal(2)
                blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.03))
                x[j, :, :, 0] += 1.8 * blob
        silos.append(
            Participant(x.astype(np.float32), y)
        )
    return silos


@dataclasses.dataclass
class LMStream:
    """Deterministic synthetic token stream for the pod-scale driver."""

    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, batch_size: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        # order-2 mixture process: next token depends on previous via a
        # banded transition, giving a learnable low-entropy structure
        v = self.vocab_size
        toks = np.empty((batch_size, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, batch_size)
        drift = rng.integers(1, 7, (batch_size, 1))
        noise = rng.integers(0, v, (batch_size, self.seq_len))
        use_noise = rng.random((batch_size, self.seq_len)) < 0.15
        for t in range(self.seq_len):
            nxt = (toks[:, t] + drift[:, 0]) % v
            toks[:, t + 1] = np.where(use_noise[:, t], noise[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def make_lm_stream(vocab_size: int, seq_len: int, seed: int = 0) -> LMStream:
    return LMStream(vocab_size, seq_len, seed)

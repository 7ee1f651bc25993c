"""Deprecated host-level entry points for the paper's federation arms, and
the PATE baseline.

Counterpart of ``repro.core.federation``.  Every arm's training numerics
live in one place, ``repro_torch.arms``, and run on the idealized backend
(``repro_torch.arms.LocalRunner``) or under simulated time
(``repro_torch.arms.SimRunner``).  The ``run_*`` functions below are thin
deprecation shims over the idealized backend, kept for pre-refactor
callers; new code should use::

    import repro_torch.arms as arms
    report = arms.run("decaph", model, silos, arms.ArmConfig(...))

``FederationConfig`` is an alias of :class:`repro_torch.arms.ArmConfig`
and ``RunResult`` of :class:`repro_torch.arms.RunReport`.  ``run_pate`` is
not deprecated: it is a one-shot pipeline over the ``local`` arm, not a
per-round protocol, and this stays its entry point.

The device follows the model: every run trains where ``model.init_fn``
puts the parameters, and PATE's teachers vote where their parameters lie.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.arms import LocalRunner, RunReport, get
from repro_torch.arms.base import (
    ArmConfig,
    Model,
    Participant,
    normalize_participants,
    poisson_batch as _new_poisson_batch,
    sgd_update,
)
from repro_torch.arms.results import RoundLog
from repro_torch.tree import tree_device

__all__ = [
    "FederationConfig",
    "Model",
    "Participant",
    "RoundLog",
    "RunResult",
    "RUNNERS",
    "normalize_participants",
    "run_decaph",
    "run_fl",
    "run_local",
    "run_pate",
    "run_primia",
]

# Legacy aliases: the same objects under their historical names.
FederationConfig = ArmConfig
RunResult = RunReport
_sgd_update = sgd_update
_poisson_batch = _new_poisson_batch


def _deprecated(old: str, arm: str) -> None:
    warnings.warn(
        f"repro_torch.core.federation.{old} is deprecated; use "
        f"repro_torch.arms.run({arm!r}, ...) (idealized backend) or "
        f"repro_torch.arms.SimRunner for simulated time",
        DeprecationWarning,
        stacklevel=3,
    )


def _run_ideal(arm_name: str, model: Model,
               participants: Sequence[Participant],
               cfg: ArmConfig) -> RunReport:
    # The reference pins its historical per-participant loop here, because
    # its fused cohort step re-associates at the ulp level.  The port's
    # per-participant path is the cohort step on a cohort of one, bit for
    # bit the fused round; the pin is kept so both packages run one path.
    cfg = dataclasses.replace(cfg, fused_rounds=False)
    return LocalRunner().run(get(arm_name)(model, participants, cfg))


def run_decaph(model, participants, cfg, *, eval_fn=None) -> RunResult:
    """The DeCaPH protocol, Steps 1-7 of the paper (idealized backend)."""
    _deprecated("run_decaph", "decaph")
    return _run_ideal("decaph", model, participants, cfg)


def run_fl(model, participants, cfg) -> RunResult:
    """FL without DP: FedSGD, or FedAvg when ``cfg.fl_local_steps > 1``."""
    _deprecated("run_fl", "fl")
    return _run_ideal("fl", model, participants, cfg)


def run_primia(model, participants, cfg) -> RunResult:
    """PriMIA-style local-DP FL with per-client accountants."""
    _deprecated("run_primia", "primia")
    return _run_ideal("primia", model, participants, cfg)


def run_local(model, participants, cfg) -> RunResult:
    """Silo-only baselines: one independent non-private model per silo."""
    _deprecated("run_local", "local")
    return _run_ideal("local", model, participants, cfg)


def run_pate(
    model: Model,
    participants: Sequence[Participant],
    cfg: ArmConfig,
    *,
    public_x: np.ndarray,
    n_classes: int = 2,
    gnmax_sigma: float = 2.0,
) -> RunResult:
    """PATE/GNMax baseline (paper Supplementary, "Existing frameworks").

    Each hospital trains a local teacher (the ``local`` arm); a student is
    trained on public data labelled by the noisy argmax of teacher votes.
    The paper argues this class of frameworks needs (a) a public dataset
    and (b) MANY teachers to get good labels at reasonable ε: with 3-8
    hospitals the vote margin is tiny, so utility collapses.

    ε accounting: each query is a Gaussian mechanism with per-teacher
    sensitivity 1, so RDP(α) = α/(2σ²) per query, composed over the
    |public_x| queries (the data-independent bound).

    The teachers predict on the device of their parameters; the votes, the
    GNMax noise (``np.random.default_rng(cfg.seed)``, the reference's draw)
    and the labels are host numpy.
    """
    from repro_torch.core.accountant import DEFAULT_ORDERS, rdp_to_eps_delta

    # 1) local teachers (silo-only training via the registered arm)
    teachers = _run_ideal("local", model, participants, cfg).per_node_params

    # 2) noisy-vote labelling of the public pool
    rng = np.random.default_rng(cfg.seed)
    votes = np.zeros((len(public_x), n_classes), np.float64)
    for t in teachers:
        x = torch.as_tensor(public_x, device=tree_device(t))
        if x.is_floating_point():   # jnp.asarray's float32 without x64
            x = x.float()
        with torch.no_grad():
            pred = model.predict_fn(t, x).cpu().numpy()
        if pred.ndim == 1:  # binary score -> two-column votes
            cls = (pred > 0.5).astype(int)
        else:
            cls = pred.argmax(-1)
        votes[np.arange(len(public_x)), cls] += 1.0
    noisy = votes + rng.normal(0, gnmax_sigma, votes.shape)
    labels = noisy.argmax(-1).astype(
        np.float32 if n_classes == 2 else np.int32)

    # 3) privacy: Q Gaussian queries composed in RDP
    orders = np.asarray(DEFAULT_ORDERS)
    rdp = len(public_x) * orders / (2.0 * gnmax_sigma**2)
    eps, _ = rdp_to_eps_delta(rdp, orders, cfg.dp.delta)

    # 4) student trained on the noisy labels (plain SGD; labels are public)
    student = Participant(public_x.astype(np.float32), labels)
    res = _run_ideal("local", model, [student], cfg)
    return RunResult(
        params=res.per_node_params[0], logs=[], epsilon=float(eps),
        rounds_completed=cfg.rounds, arm="pate", backend="ideal",
    )


RUNNERS = {
    "decaph": run_decaph,
    "fl": run_fl,
    "primia": run_primia,
    "local": run_local,
    "pate": run_pate,
}

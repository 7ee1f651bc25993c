"""repro_torch.arms — federation arms on the port's backends.

Counterpart of ``repro.arms``: an ``Arm`` declares a protocol's per-round
numerics, a backend executes it, and ``run`` validates the pair before
any compute.  The same call as the reference's:

    import repro_torch.arms as arms
    from repro_torch.serve.federation import token_silos, transformer_model

    report = arms.run("decaph", transformer_model(cfg), token_silos(cfg, ...),
                      arms.ArmConfig(rounds=3, use_secagg=False),
                      backend="ideal")

Ported so far: the ``decaph`` arm on the ``ideal`` backend (the fused
cohort round, ghost or per-example clipping, noise shares, the RDP
accountant and the privacy ledger).  SecAgg, the simulated-time backend
and the other arms are still to port (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

from typing import Sequence

import repro_torch.obs as obs
from repro_torch.arms import backends, clipping
from repro_torch.arms.backends import BackendInfo
from repro_torch.arms.base import (
    AggregationServices,
    Arm,
    ArmConfig,
    Contribution,
    Model,
    Participant,
    RoundArm,
    RoundOutcome,
    poisson_batch,
    sgd_update,
    tree_bytes,
    tree_sum,
)
from repro_torch.arms.clipping import GhostCapability
from repro_torch.arms.registry import get, names, register
from repro_torch.arms.results import RoundLog, RunReport
from repro_torch.arms.runners import LocalRunner

# importing the arm modules is what registers them
from repro_torch.arms import decaph as _decaph  # noqa: F401


def run(name: str, model: Model, participants: Sequence[Participant],
        cfg: ArmConfig, *, backend: str = backends.DEFAULT_BACKEND,
        on_round=None) -> RunReport:
    """Instantiate arm ``name`` and execute it on the chosen backend.

    The (arm, backend, config) triple and the clipping path are validated
    before any compute; ``on_round(t, params)`` is called after every
    completed round.
    """
    arm_cls = get(name)
    backends.validate_run(arm_cls, backend, cfg)
    clipping.resolve(model, cfg)
    runner = LocalRunner(on_round=on_round)
    with obs.span("arms.run", cat="train", arm=name, backend=backend,
                  hospitals=len(participants)):
        return runner.run(arm_cls(model, participants, cfg))


__all__ = [
    "AggregationServices",
    "Arm",
    "ArmConfig",
    "BackendInfo",
    "Contribution",
    "GhostCapability",
    "LocalRunner",
    "Model",
    "Participant",
    "RoundArm",
    "RoundLog",
    "RoundOutcome",
    "RunReport",
    "backends",
    "clipping",
    "get",
    "names",
    "poisson_batch",
    "register",
    "run",
    "sgd_update",
    "tree_bytes",
    "tree_sum",
]

"""repro_torch.arms — federation arms on the port's backends.

Counterpart of ``repro.arms``: an ``Arm`` declares a protocol's per-round
numerics, a backend executes it, and ``run`` validates the pair before
any compute.  The same call as the reference's:

    import repro_torch.arms as arms
    from repro_torch.serve.federation import token_silos, transformer_model

    report = arms.run("decaph", transformer_model(cfg), token_silos(cfg, ...),
                      arms.ArmConfig(rounds=3, use_secagg=False),
                      backend="ideal")

or, the paper's own experiments (DP noise shares behind SecAgg, the
``ArmConfig()`` default):

    from repro_torch.data import make_pancreas_like
    from repro_torch.models.tabular import make_mlp_classifier

    report = arms.run("decaph",
                      make_mlp_classifier([15558, 1000, 100, 4], "multiclass"),
                      arms.normalize_participants(make_pancreas_like(...)),
                      arms.ArmConfig(rounds=3))

or under simulated time, with hospitals that run at different speeds and
drop out (dropout-robust SecAgg recovers their pads):

    from repro_torch.sim import heterogeneous_trace, nodes_from_trace

    timed = arms.run("decaph", model, silos, cfg, backend="sim",
                     nodes=nodes_from_trace(heterogeneous_trace(len(silos))))

Registered arms, as in the reference: decaph, fl (FedSGD/FedAvg), fedprox
(proximal-term FedAvg), scaffold (control-variate FedAvg), primia
(local-DP FL), local (silo-only), gossip (async D-PSGD), gossip-dp
(local-DP D-PSGD).  Registered backends: ``ideal``, ``sim`` and the
trace-then-solve ``population`` (``backends.backend_names()``), the only
one that honours ``participation_rate < 1``.
"""

from __future__ import annotations

from typing import Sequence

import repro_torch.obs as obs
from repro_torch.arms import backends, clipping
from repro_torch.arms.backends import BackendInfo, RunSetup, register_backend
from repro_torch.arms.base import (
    AggregationServices,
    Arm,
    ArmConfig,
    Contribution,
    Model,
    NodeArm,
    Participant,
    RoundArm,
    RoundOutcome,
    normalize_participants,
    poisson_batch,
    sgd_update,
    tree_bytes,
    tree_sum,
)
from repro_torch.arms.clipping import GhostCapability
from repro_torch.arms.registry import get, names, register
from repro_torch.arms.results import RoundLog, RunReport, SimTiming
from repro_torch.arms.runners import LocalRunner, SimRunner, default_topology

# importing the arm modules is what registers them
from repro_torch.arms import decaph as _decaph          # noqa: F401
from repro_torch.arms import fedprox as _fedprox        # noqa: F401
from repro_torch.arms import fl as _fl                  # noqa: F401
from repro_torch.arms import gossip as _gossip          # noqa: F401
from repro_torch.arms import gossip_dp as _gossip_dp    # noqa: F401
from repro_torch.arms import local as _local            # noqa: F401
from repro_torch.arms import primia as _primia          # noqa: F401
from repro_torch.arms import scaffold as _scaffold      # noqa: F401


def run(name: str, model: Model, participants: Sequence[Participant],
        cfg: ArmConfig, *, backend: str = backends.DEFAULT_BACKEND,
        nodes=None, topo=None, mesh=None, on_round=None) -> RunReport:
    """Instantiate arm ``name`` and execute it on the chosen backend.

    ``backend`` is any name from ``backends.backend_registry()``; the
    (arm, backend, config) triple and the clipping path are validated
    before any compute.  Each backend consumes the ``RunSetup`` fields it
    understands — ``nodes`` (one ``HospitalNode`` per participant) for
    simulated time, ``mesh`` (a ``DeviceMesh``, ``launch.mesh``) for the
    SPMD ``shard`` backend — and rejects what it requires but did not get.
    ``topo`` defaults to the arm's natural topology; ``on_round(t, params)``
    is called after every completed round.
    """
    arm_cls = get(name)
    backend_cls = backends.get_backend(backend)
    backends.validate_run(arm_cls, backend_cls.info, cfg)
    clipping.resolve(model, cfg)
    runner = backend_cls.from_setup(
        RunSetup(nodes=nodes, topo=topo, mesh=mesh, on_round=on_round))
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
    "NodeArm",
    "Participant",
    "RoundArm",
    "RoundLog",
    "RoundOutcome",
    "RunReport",
    "RunSetup",
    "SimRunner",
    "SimTiming",
    "backends",
    "clipping",
    "default_topology",
    "get",
    "names",
    "normalize_participants",
    "poisson_batch",
    "register",
    "register_backend",
    "run",
    "sgd_update",
    "tree_bytes",
    "tree_sum",
]

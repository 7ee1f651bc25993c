"""Deprecated per-arm simulator entry points (thin Arm/Backend shims).

Counterpart of ``repro.sim.protocols``.  The numerics live once in
``repro_torch.arms`` and the discrete-event execution in
``repro_torch.arms.SimRunner``; each ``simulate_*`` below binds a
registered arm to that backend.  New code should use::

    import repro_torch.arms as arms
    report = arms.run("decaph", model, silos, cfg, backend="sim",
                      nodes=nodes, topo=topo)

``SimConfig`` is :class:`repro_torch.arms.ArmConfig` with the historical
default of 20 rounds, and ``ArmReport`` is :class:`repro_torch.arms.RunReport`
(the systems metrics live in its ``timing`` section and stay readable under
their historical names: ``wall_clock``, ``bytes_on_wire``, ``recoveries``,
...).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

from repro_torch.arms import ArmConfig, RunReport, SimRunner, get
from repro_torch.arms.base import Model, Participant  # noqa: F401  (legacy re-export)
from repro_torch.sim.nodes import HospitalNode, nodes_from_trace
from repro_torch.sim.topology import Topology

__all__ = [
    "ArmReport",
    "SIM_RUNNERS",
    "SimConfig",
    "scenario_from_trace",
    "simulate_decaph",
    "simulate_fl",
    "simulate_gossip",
    "simulate_gossip_dp",
    "simulate_local",
    "simulate_primia",
]

# Legacy alias: the historical name of the unified result type.
ArmReport = RunReport


@dataclasses.dataclass
class SimConfig(ArmConfig):
    """Legacy name for :class:`repro_torch.arms.ArmConfig`.

    Only difference: the historical default of 20 rounds (ArmConfig keeps
    100), so pre-refactor ``SimConfig()`` callers do not silently get a 5x
    longer simulation.
    """

    rounds: int = 20


def _simulate(arm_name: str):
    def shim(
        model: Model,
        participants: Sequence[Participant],
        nodes: Sequence[HospitalNode],
        topo: Topology,
        cfg: ArmConfig,
    ) -> RunReport:
        warnings.warn(
            f"repro_torch.sim.protocols.simulate_"
            f"{arm_name.replace('-', '_')} is deprecated; use "
            f"repro_torch.arms.run({arm_name!r}, ..., "
            "backend='sim', nodes=..., topo=...)",
            DeprecationWarning,
            stacklevel=2,
        )
        return SimRunner(nodes, topo).run(get(arm_name)(model, participants, cfg))

    shim.__name__ = f"simulate_{arm_name.replace('-', '_')}"
    shim.__qualname__ = shim.__name__
    return shim


simulate_decaph = _simulate("decaph")
simulate_fl = _simulate("fl")
simulate_primia = _simulate("primia")
simulate_local = _simulate("local")
simulate_gossip = _simulate("gossip")
simulate_gossip_dp = _simulate("gossip-dp")

SIM_RUNNERS: dict[str, Callable[..., RunReport]] = {
    "decaph": simulate_decaph,
    "fl": simulate_fl,
    "primia": simulate_primia,
    "local": simulate_local,
    "gossip": simulate_gossip,
    "gossip-dp": simulate_gossip_dp,
}


def scenario_from_trace(
    trace: dict,
) -> tuple[list[HospitalNode], Topology]:
    """Build (nodes, topology) from one JSON-serialisable scenario dict:

    {"nodes": [{"throughput": ..., "overhead": ..., "dropouts": [...]}, ...],
     "topology": {"kind": "full", "default": {...}, ...}}

    ``topology.n`` defaults to ``len(nodes)``.
    """
    nodes = nodes_from_trace(trace["nodes"])
    topo_spec = dict(trace.get("topology") or {"kind": "full"})
    topo_spec.setdefault("n", len(nodes))
    return nodes, Topology.from_trace(topo_spec)

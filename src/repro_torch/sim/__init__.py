"""repro_torch.sim — the discrete-event multi-hospital simulator.

The port's copy of ``repro.sim``: the engine (events, simulated clock) and
the systems models (hospital nodes, topology with link churn), host Python
and numpy throughout.  The simulated-time backend that drives arms through
them is ``repro_torch.arms.runners.SimRunner`` (``backend="sim"``).  The
reference's deprecated ``simulate_*`` shims, ``SimConfig``, ``ArmReport``
and ``scenario_from_trace`` live in ``sim.protocols``.

Implementation note: the protocol names are loaded lazily (PEP 562)
because ``repro_torch.arms``, which ``protocols`` imports, itself imports
the engine from this package; eager loading would be a circular import.
"""

from repro_torch.sim.engine import (
    ComputeDone,
    EventEngine,
    NodeDropout,
    NodeRejoin,
    TransferDone,
)
from repro_torch.sim.nodes import (
    HospitalNode,
    heterogeneous_trace,
    node_from_trace,
    nodes_from_trace,
)
from repro_torch.sim.topology import Link, LinkChange, LinkSchedule, Topology

_PROTOCOL_NAMES = (
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
)


def __getattr__(name: str):
    if name in _PROTOCOL_NAMES:
        from repro_torch.sim import protocols

        return getattr(protocols, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ComputeDone",
    "EventEngine",
    "HospitalNode",
    "Link",
    "LinkChange",
    "LinkSchedule",
    "NodeDropout",
    "NodeRejoin",
    "Topology",
    "TransferDone",
    "heterogeneous_trace",
    "node_from_trace",
    "nodes_from_trace",
    *_PROTOCOL_NAMES,
]

"""repro_torch.sim — the discrete-event multi-hospital simulator.

The port's copy of ``repro.sim``: the engine (events, simulated clock) and
the systems models (hospital nodes, topology with link churn), host Python
and numpy throughout.  The simulated-time backend that drives arms through
them is ``repro_torch.arms.runners.SimRunner`` (``backend="sim"``).  The
reference's deprecated ``simulate_*`` shims are not ported (ROADMAP.md,
Queue 1).
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
]

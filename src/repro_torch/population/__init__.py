"""repro_torch.population — the trace-then-solve cross-device engine.

Counterpart of ``repro.population`` (DESIGN.md §10).  The ``sim`` backend
interleaves event scheduling with model compute, welding "one simulated
hospital" to "one compute step", which caps H at a few dozen.  This
package decouples them:

  * **trace** (``population.trace``) — a discrete-event pass with NO model
    compute over per-hospital availability/throughput traces, a sparse
    topology (k-regular / small-world at H=1000, link churn) and a Poisson
    **cohort sampler** (``population.sampler``), emitting a timestamped,
    content-addressed **compute graph** (``population.graph``).
    Byte-identical for a fixed seed, and byte for byte the reference's
    for the same inputs;
  * **solve** (``population.solve``) — walks that graph's rounds and
    executes each round's cohort as ONE fused cohort step on the device,
    with a ``SolveReport`` separating simulated time from host wall time.

``population.backend`` registers the pair as the ``population`` backend
(fused-only, no SecAgg wire protocol: its cost is modeled at the
aggregate level).  ``PopulationSpec`` (``population.spec``) generates
1000-hospital node/topology traces from distributions, consumable from
``ScenarioSpec.population``; ``python -m repro_torch.population`` is the
CLI.  Importing this package, or its spec, sampler, graph and trace
modules, loads no torch.
"""

from __future__ import annotations

from repro_torch.population.graph import ComputeGraph, TraceNode
from repro_torch.population.sampler import CohortSampler
from repro_torch.population.spec import PopulationSpec

__all__ = [
    "CohortSampler",
    "ComputeGraph",
    "PopulationSpec",
    "TraceNode",
]

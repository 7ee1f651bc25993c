"""The ``population`` backend: trace-then-solve cross-device execution.

Counterpart of ``repro.population.backend``, registered with the §8
registry like any other backend; ``run(arm)`` does the two-phase dance:

  1. **trace** (``population.trace.run_trace``) — discrete-event timestamp
     arithmetic over the node/topology traces, no model compute, emitting
     the content-addressed compute graph and per-round plans;
  2. **solve** (``population.solve.solve``) — execute the non-lost rounds
     through the arm's fused cohort round-step, one program call per round.

Capability record, the reference's: ``supports_secagg=False`` because no
SecAgg wire protocol runs — SecAgg *cost* is still modeled at the
aggregate level when the arm declares ``secure_uploads`` (setup/recovery
bytes, recovery latency), but no ciphertext ever exists, so configs
requesting ``use_secagg=True`` are refused at validation instead of
silently running plaintext.  ``supports_subsampling=True`` makes this the
one backend where ``participation_rate < 1`` is allowed: the trace's
``CohortSampler`` uses the exact ``q`` the arm's accountant composes at.
``bit_exact_group`` is empty — the backend is fused-only, so the
registry-wide "every group member runs every arm" promise cannot hold;
the q=1 bit-identity with the ``ideal`` backend is pinned by an explicit
test instead (``tests/test_torch_population.py``).
"""

from __future__ import annotations

from typing import Sequence

import repro_torch.obs as obs
from repro_torch.arms.backends import BackendInfo, RunSetup, register_backend
from repro_torch.arms.base import Arm, RoundArm, tree_bytes
from repro_torch.arms.results import RunReport, SimTiming
from repro_torch.arms.runners import default_topology
from repro_torch.population.solve import SolveReport, solve
from repro_torch.population.trace import Trace, run_trace
from repro_torch.sim.nodes import HospitalNode
from repro_torch.sim.topology import Topology

# Trace-default hardware when the caller pins no nodes: every hospital a
# mid-range box, always online (the idealized-conditions population).
_DEFAULT_THROUGHPUT = 400.0
_DEFAULT_OVERHEAD = 0.02


@register_backend(BackendInfo(
    name="population",
    supports_fused=True,
    supports_secagg=False,
    supports_sim_time=True,
    fused_only=True,
    supports_subsampling=True,
    bit_exact_group="",
    description="trace-then-solve cross-device engine: event-free trace "
                "phase over 1000-hospital populations, fused batched solve",
))
class PopulationRunner:
    """Trace-then-solve execution of fused-capable round arms."""

    def __init__(self, nodes: Sequence[HospitalNode] | None = None,
                 topo: Topology | None = None, on_round=None) -> None:
        self.nodes = list(nodes) if nodes is not None else None
        self.topo = topo
        self.on_round = on_round
        self.last_trace: Trace | None = None
        self.last_solve: SolveReport | None = None

    @classmethod
    def from_setup(cls, setup: RunSetup) -> "PopulationRunner":
        return cls(setup.nodes, setup.topo, on_round=setup.on_round)

    def trace(self, arm: Arm) -> Trace:
        """The trace phase alone — no model compute, fresh every call.

        Consumes no arm state (``round_cost``/``quorum``/``facilitator``
        are pure), so tracing twice with fresh topologies is the
        determinism check the CLI exposes.
        """
        if not isinstance(arm, RoundArm) or not arm.fused_capable:
            raise TypeError(
                f"backend 'population' only executes fused-capable round "
                f"arms; got {arm.name!r} (mode={arm.mode!r})"
            )
        cfg = arm.cfg
        nodes = self.nodes
        if nodes is None:
            nodes = [
                HospitalNode(i, _DEFAULT_THROUGHPUT, _DEFAULT_OVERHEAD)
                for i in range(arm.h)
            ]
        if len(nodes) != arm.h:
            raise ValueError(
                f"one HospitalNode per participant required "
                f"({len(nodes)} nodes, {arm.h} participants)"
            )
        topo = self.topo or default_topology(arm.topology_kind, arm.h,
                                             cfg.fl_server)
        topo.advance_to(0.0)
        model_bytes = tree_bytes(arm.init_params(), cfg.bytes_per_param)
        minimum, require = arm.quorum()
        # secure=True models the aggregate-level SecAgg cost whenever the
        # arm's protocol runs behind SecAgg in production, even though this
        # backend never executes the wire protocol (use_secagg is refused)
        with obs.span("population.trace", cat="population",
                      hospitals=arm.h, rounds=arm.planned_rounds()):
            return run_trace(
                nodes, topo,
                rounds=arm.planned_rounds(),
                q=cfg.participation_rate,
                seed=cfg.seed,
                sizes=[arm.round_cost(i) for i in range(arm.h)],
                model_bytes=model_bytes,
                secure=arm.secure_uploads,
                quorum=minimum,
                require=require,
                facilitator=arm.facilitator,
                secagg_threshold=cfg.secagg_threshold,
                eval_every=cfg.eval_every,
            )

    def run(self, arm: Arm) -> RunReport:
        trace = self.trace(arm)
        with obs.span("population.solve", cat="population",
                      hospitals=arm.h, rounds=len(trace.rounds)):
            result = solve(trace, arm, on_round=self.on_round)
        self.last_trace = trace
        self.last_solve = result.report
        rep = result.report
        return RunReport(
            params=result.params, logs=result.logs, epsilon=result.epsilon,
            rounds_completed=rep.rounds_completed, arm=arm.name,
            backend=self.backend,
            timing=SimTiming(
                wall_clock=rep.simulated_seconds,
                bytes_on_wire=rep.bytes_on_wire,
                dropout_events=rep.dropout_events,
                recoveries=rep.recoveries,
                lost_rounds=rep.lost_rounds,
                events=trace.events,
                noise_topups=rep.noise_topups,
            ),
        )

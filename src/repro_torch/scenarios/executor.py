"""Execute scenario specs: one cell, or a cached, process-parallel sweep.

Counterpart of ``repro.scenarios.executor``.  ``run_spec`` materialises a
``ScenarioSpec`` (cohort, model, nodes, topology, arm config) on a device,
runs it through ``repro_torch.arms.run`` and returns a plain-JSON metrics
dict — the reference's keys.  ``run_sweep`` drives a list of specs through
the result cache: hits are served from disk, misses execute — inline for
``jobs=1``, else on a spawn-context process pool (a CUDA context does not
survive forking), each worker on the device the sweep names — and every
fresh result is persisted, making sweeps resumable.

Torch-heavy imports happen inside functions: a fully-cached sweep never
builds models, data or backends (it still pays the one arm-registry
import that sweep-axis expansion needs — see ``grid._registered_arms``).
The reference also points JAX's persistent compilation cache under the
result cache; the port runs eagerly and has nothing to cache there.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Sequence

import repro_torch.obs as obs
from repro_torch.scenarios import presets as presets_lib
from repro_torch.scenarios.cache import ResultCache
from repro_torch.scenarios.spec import ScenarioSpec


def build_scenario(spec: ScenarioSpec, *, device="cuda"):
    """(model, silos, cfg, nodes, topo) — everything ``repro_torch.arms.run``
    needs, the model on ``device``.

    ``nodes``/``topo`` are None for the idealized backend.
    """
    import repro_torch.arms as arms
    from repro_torch.arms import backends as backends_lib
    from repro_torch.core.dp import DPConfig
    from repro_torch.sim import Topology, nodes_from_trace

    arm_cls = arms.get(spec.arm)  # validates the arm name early
    backend_info = backends_lib.get_backend(spec.backend).info
    model = presets_lib.build_model(spec, device=device)
    silos = presets_lib.build_silos(spec)
    if presets_lib.normalizes(spec.task):
        silos = arms.normalize_participants(silos)
    cfg = arms.ArmConfig(
        rounds=spec.rounds, batch_size=spec.batch_size, lr=spec.lr,
        seed=spec.seed, use_secagg=spec.use_secagg,
        fl_local_steps=spec.fl_local_steps, fedprox_mu=spec.fedprox_mu,
        epsilon_budget=spec.epsilon_budget,
        participation_rate=spec.participation_rate,
        clipping=spec.clipping,
        dp=DPConfig(clip_norm=spec.clip_norm,
                    noise_multiplier=spec.noise_multiplier,
                    microbatch_size=spec.microbatch_size),
    )
    if not backend_info.supports_sim_time:
        return model, silos, cfg, None, None
    if spec.population is not None:
        # distributional cell: materialise the node/topology traces from the
        # population description (deterministic in spec.seed)
        from repro_torch.population.spec import PopulationSpec

        pop = PopulationSpec.from_dict(
            {"hospitals": spec.hospitals, "seed": spec.seed,
             **spec.population}
        )
        return (model, silos, cfg, nodes_from_trace(pop.build_nodes()),
                Topology.from_trace(pop.build_topology()))
    nodes = nodes_from_trace(presets_lib.default_nodes(spec))
    if spec.topology is not None:
        topo_spec = dict(spec.topology)
        topo_spec.setdefault("n", spec.hospitals)
        topo = Topology.from_trace(topo_spec)
    else:
        kind = arm_cls.topology_kind
        spec_kind = {"kind": kind, "n": spec.hospitals,
                     "default": {"bandwidth": spec.bandwidth,
                                 "latency": spec.latency}}
        if kind == "star":
            spec_kind["center"] = cfg.fl_server
        topo = Topology.from_trace(spec_kind)
    return model, silos, cfg, nodes, topo


def n_params(params) -> int:
    """Parameter count of a tree (a 0-d or empty leaf counts 1, as the
    reference's ``np.prod(shape) or 1``)."""
    from repro_torch.tree import tree_leaves

    return int(sum(leaf.numel() or 1 for leaf in tree_leaves(params)))


def run_spec(spec: ScenarioSpec, *, device="cuda") -> dict:
    """Execute one cell on ``device`` and return its plain-JSON metrics."""
    import repro_torch.arms as arms
    from repro_torch.arms.results import SimTiming

    model, silos, cfg, nodes, topo = build_scenario(spec, device=device)
    rec = obs.recorder()
    spans_before = rec.span_totals() if rec is not None else None
    t0 = time.time()
    with obs.span("sweep.cell", cat="sweep", cell=spec.name, arm=spec.arm,
                  backend=spec.backend, hospitals=spec.hospitals):
        rep = arms.run(spec.arm, model, silos, cfg, backend=spec.backend,
                       nodes=nodes, topo=topo)
    host_seconds = time.time() - t0
    # rep.params is always the arm's headline model: node arms pick it in
    # consensus() (local -> node 0, gossip -> the average)
    headline = rep.params
    # the idealized backend has no systems story: its fields read 0
    timing = rep.timing or SimTiming()
    mean_loss = rep.mean_loss()
    row = {
        "name": spec.name,
        "key": spec.spec_hash(),
        "task": spec.task,
        "arm": spec.arm,
        "backend": spec.backend,
        "hospitals": spec.hospitals,
        "model_size": spec.model_size,
        "model_params": n_params(headline),
        "rounds_completed": rep.rounds_completed,
        "epsilon": float(rep.epsilon),
        # None (JSON null), not NaN: NaN breaks strict JSON consumers and
        # NaN != NaN would make cached results compare unequal to fresh ones
        "mean_loss": float(mean_loss) if math.isfinite(mean_loss) else None,
        "accuracy": presets_lib.pooled_metric(spec, model, headline, silos),
        "wall_clock": float(timing.wall_clock),
        "bytes_on_wire": float(timing.bytes_on_wire),
        "dropout_events": int(timing.dropout_events),
        "recoveries": int(timing.recoveries),
        "lost_rounds": int(timing.lost_rounds),
        "events": int(timing.events),
        "noise_topups": int(timing.noise_topups),
        "host_seconds": host_seconds,
    }
    if spans_before is not None:
        # per-cell host-time phase breakdown (fused round vs aggregate vs
        # transport ...) — the delta of the recorder's span totals across
        # this cell, surfaced in the BENCH row only when recording is on
        after = rec.span_totals()
        row["phase_seconds"] = {
            name: round(total - (spans_before.get(name) or (0, 0.0))[1], 6)
            for name, (_, total) in sorted(after.items())
            if total - (spans_before.get(name) or (0, 0.0))[1] > 0
            and name != "sweep.cell"
        }
    return row


def _pool_cell(spec_dict: dict, device: str) -> dict:
    """Top-level pool target (must be picklable under spawn)."""
    return run_spec(ScenarioSpec.from_dict(spec_dict), device=device)


@dataclasses.dataclass
class SweepOutcome:
    """What a sweep invocation did: the results plus cache bookkeeping."""

    results: list[dict]
    hits: int
    misses: int
    elapsed: float

    @property
    def cells(self) -> int:
        return len(self.results)


def run_sweep(
    specs: Sequence[ScenarioSpec],
    cache: ResultCache,
    *,
    jobs: int = 1,
    force: bool = False,
    runner: Callable[[ScenarioSpec], dict] | None = None,
    progress: Callable[[str], None] | None = None,
    device="cuda",
) -> SweepOutcome:
    """Run every spec through the cache; execute only the misses, on
    ``device``.

    ``runner`` overrides cell execution (tests inject a counting fake; the
    process pool is bypassed whenever a runner is given or ``jobs <= 1``).
    """
    t0 = time.time()
    say = progress or (lambda msg: None)
    results: list[dict | None] = [None] * len(specs)
    pending: list[int] = []
    hits = 0
    for idx, spec in enumerate(specs):
        cached = None if force else cache.get(spec)
        if cached is not None:
            # relabel on serve: names are excluded from the cache key, so a
            # renamed sweep/cell must not surface its original label
            results[idx] = {**cached, "name": spec.name}
            hits += 1
        else:
            pending.append(idx)
    say(f"{len(specs)} cells: {hits} cached, {len(pending)} to run")

    if pending:
        if runner is None and jobs > 1 and len(pending) > 1:
            # spawn, not fork: a CUDA context (or torch's thread pools) do
            # not survive forking.  Every finished cell is cached as it
            # completes, so one failing cell costs only itself — the re-run
            # resumes from everything that succeeded.
            import multiprocessing as mp
            from concurrent.futures import as_completed

            ctx = mp.get_context("spawn")
            first_error: BaseException | None = None
            with ProcessPoolExecutor(max_workers=min(jobs, len(pending)),
                                     mp_context=ctx) as pool:
                futures = {
                    pool.submit(_pool_cell, specs[i].to_dict(), str(device)): i
                    for i in pending
                }
                for fut in as_completed(futures):
                    idx = futures[fut]
                    try:
                        results[idx] = fut.result()
                    except BaseException as e:  # noqa: BLE001 - re-raised
                        say(f"FAILED {specs[idx].name}: {e}")
                        first_error = first_error or e
                        continue
                    cache.put(specs[idx], results[idx])
                    say(f"ran  {specs[idx].name}")
            if first_error is not None:
                raise first_error
        else:
            run_one = runner or functools.partial(run_spec, device=device)
            for idx in pending:
                results[idx] = run_one(specs[idx])
                cache.put(specs[idx], results[idx])
                say(f"ran  {specs[idx].name}")

    return SweepOutcome(
        results=[r for r in results if r is not None],
        hits=hits, misses=len(pending), elapsed=time.time() - t0,
    )

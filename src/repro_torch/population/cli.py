"""``python -m repro_torch.population`` — cross-device scaling runs + artifacts.

    python -m repro_torch.population --hospitals 50,200,1000 --seeds 0,1,2
    python -m repro_torch.population --hospitals 1000 --seeds 0
    python -m repro_torch.population --hospitals 200 --rounds 4 \
        --participation 0.25 --check-determinism --device cpu

Counterpart of ``python -m repro.population``, with ``--device`` (the card
unless ``--device cpu`` is given); the default artifact is
``BENCH_torch_population.json`` (with its ``.md``), never the reference's.

Each (arm, H, seed) cell runs the trace-then-solve engine *directly*
(``PopulationRunner``, not the scenario cache), because this CLI reports
what the scenario metrics dict flattens away: the solve report's two
clocks (simulated vs host seconds), the compute-graph size and content
hash, and the realised cohort statistics.  ``--check-determinism``
re-traces every cell and fails the run unless the compute graph is
byte-identical — the DESIGN.md §10 contract.

The artifact carries per-cell records, the
seed-collapsed groups with confidence intervals, and power-law fits
(wall vs H, bytes vs H) over the group means — the same report helpers
the sweep artifacts use, so the numbers are directly comparable.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _cell_spec(args, arm: str, hospitals: int, seed: int):
    from repro_torch.scenarios.spec import ScenarioSpec

    population = {
        "topology": args.topology,
        "degree": args.degree,
        "flaky_fraction": args.flaky_fraction,
        "throughput_sigma": args.throughput_sigma,
    }
    return ScenarioSpec(
        name=f"population/arm={arm},hospitals={hospitals},seed={seed}",
        task="gemini", model_size="small", features=args.features,
        examples=args.examples, rounds=args.rounds,
        batch_size=args.batch, lr=0.4, seed=seed,
        arm=arm, backend="population", hospitals=hospitals,
        noise_multiplier=args.sigma, use_secagg=False,
        participation_rate=args.participation,
        population=population,
    )


def _run_cell(spec, check_determinism: bool, device) -> dict:
    import repro_torch.arms as arms_lib
    from repro_torch.arms import backends as backends_lib
    from repro_torch.population.backend import PopulationRunner
    from repro_torch.scenarios import presets as presets_lib
    from repro_torch.scenarios.executor import build_scenario, n_params

    model, silos, cfg, nodes, topo = build_scenario(spec, device=device)
    arm_cls = arms_lib.get(spec.arm)
    backends_lib.validate_run(arm_cls, PopulationRunner.info, cfg)
    arm = arm_cls(model, silos, cfg)
    runner = PopulationRunner(nodes, topo)
    t0 = time.time()
    rep = runner.run(arm)
    host_seconds = time.time() - t0
    sr = runner.last_solve
    timing = rep.timing
    record = {
        "name": spec.name,
        "task": spec.task,
        "arm": spec.arm,
        "backend": spec.backend,
        "hospitals": spec.hospitals,
        "seed": spec.seed,
        "model_size": spec.model_size,
        "model_params": n_params(rep.params),
        "participation_rate": spec.participation_rate,
        "rounds_completed": rep.rounds_completed,
        "epsilon": float(rep.epsilon),
        "accuracy": presets_lib.pooled_metric(spec, model, rep.params, silos),
        "wall_clock": float(timing.wall_clock),     # simulated seconds
        "bytes_on_wire": float(timing.bytes_on_wire),
        "recoveries": int(timing.recoveries),
        "lost_rounds": int(timing.lost_rounds),
        "dropout_events": int(timing.dropout_events),
        "noise_topups": int(timing.noise_topups),
        "host_seconds": host_seconds,
        # solve-report extras the scenario metrics dict flattens away
        "solve_wall_seconds": sr.wall_seconds,
        "graph_nodes": sr.graph_nodes,
        "graph_hash": sr.graph_hash,
        "empirical_q": sr.empirical_q,
        "mean_cohort": sr.mean_cohort,
    }
    if check_determinism:
        # fresh nodes/topo (run_trace advances topologies); same arm — the
        # trace phase consumes no arm state
        _, _, _, nodes2, topo2 = build_scenario(spec, device=device)
        retraced = PopulationRunner(nodes2, topo2).trace(arm)
        if retraced.graph.to_json_bytes() != \
                runner.last_trace.graph.to_json_bytes():
            raise AssertionError(
                f"{spec.name}: re-trace produced a different compute graph "
                f"({retraced.graph.graph_hash()} vs {sr.graph_hash}) — "
                f"the trace phase is not deterministic"
            )
        record["determinism_checked"] = True
    return record


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.population",
        description="Trace-then-solve cross-device scaling runs.",
    )
    p.add_argument("--hospitals", type=_ints, default=[50, 200, 1000],
                   help="comma-separated cohort sizes (default 50,200,1000)")
    p.add_argument("--seeds", type=_ints, default=[0, 1, 2],
                   help="comma-separated seeds, one run per seed per cell")
    p.add_argument("--arms", default="decaph,fl",
                   help="comma-separated fused-capable round arms")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--participation", type=float, default=0.1,
                   help="Poisson cohort subsampling rate q in (0, 1]")
    p.add_argument("--topology", default="k_regular",
                   help="population overlay: k_regular | small_world | "
                        "star | ring | full")
    p.add_argument("--degree", type=int, default=8,
                   help="k for the k_regular/small_world overlays")
    p.add_argument("--flaky-fraction", type=float, default=0.05)
    p.add_argument("--throughput-sigma", type=float, default=0.5)
    p.add_argument("--examples", type=int, default=6000,
                   help="total examples across the cohort")
    p.add_argument("--features", type=int, default=16)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--sigma", type=float, default=0.8,
                   help="DP noise multiplier")
    p.add_argument("--check-determinism", action="store_true",
                   help="re-trace every cell; fail unless the compute graph "
                        "is byte-identical")
    p.add_argument("--out", default="BENCH_torch_population.json",
                   help="artifact path; markdown lands beside it")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    arms = [a for a in args.arms.split(",") if a]
    records = []
    for arm in arms:
        for h in args.hospitals:
            for seed in args.seeds:
                spec = _cell_spec(args, arm, h, seed)
                t0 = time.time()
                rec = _run_cell(spec, args.check_determinism, args.device)
                records.append(rec)
                print(
                    f"{spec.name}: sim {rec['wall_clock']:.1f}s over "
                    f"{rec['rounds_completed']} rounds "
                    f"({rec['graph_nodes']} graph nodes, "
                    f"solve {rec['solve_wall_seconds']:.1f}s, "
                    f"cell {time.time() - t0:.1f}s host)",
                    file=sys.stderr,
                )

    from repro_torch.scenarios import report as report_lib

    payload = {
        "suite": "population",
        "participation_rate": args.participation,
        "topology": args.topology,
        "cells": records,
        "seed_groups": report_lib.aggregate_seeds(records),
        "scaling_laws": report_lib.scaling_laws(records),
        "generated_by": "python -m repro_torch.population",
    }
    out = Path(args.out)
    out.write_text(json.dumps(payload, indent=2, sort_keys=True))
    md = out.with_suffix(".md")
    md.write_text(report_lib.markdown_report("population", records,
                                             payload["scaling_laws"]))
    print(f"wrote {out} and {md} ({len(records)} cells)", file=sys.stderr)
    for law, fits in payload["scaling_laws"].items():
        for arm, fit in sorted(fits.items()):
            print(f"  {law} [{arm}]: exponent {fit['exponent']:.3f} "
                  f"(R² {fit['r2']:.3f}, {fit['points']} pts)",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

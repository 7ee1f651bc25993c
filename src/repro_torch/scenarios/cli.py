"""``python -m repro_torch.scenarios`` — list, run, sweep, report.

    python -m repro_torch.scenarios --list
    python -m repro_torch.scenarios --run lm-full
    python -m repro_torch.scenarios --run gemini-5hospital --device cpu
    python -m repro_torch.scenarios --sweep capacity-mini
    python -m repro_torch.scenarios --sweep smoke-2x2 --assert-cached
    python -m repro_torch.scenarios --report capacity-mini

Counterpart of ``python -m repro.scenarios``, with ``--device`` (the card
unless ``--device cpu`` is given).  The default artifacts carry ``torch``
in their names (``BENCH_torch_sweep.json``, ``BENCH_torch_run.json``,
each with its ``.md``) and the default cache is ``.sweep_cache_torch``,
so a run from the repo root never overwrites the reference's.

``--sweep`` executes through the content-addressed cache (``--cache-dir``),
so a re-run only executes new/changed cells; ``--assert-cached`` turns a
fully-cached expectation into an exit code for CI.  ``--report`` re-renders
artifacts from cache alone, without executing anything.
"""

from __future__ import annotations

import argparse
import os
import sys

import repro_torch.obs as obs
from repro_torch.scenarios import grid as grid_lib
from repro_torch.scenarios import presets as presets_lib
from repro_torch.scenarios import report as report_lib
from repro_torch.scenarios.cache import DEFAULT_CACHE_DIR, ResultCache
from repro_torch.scenarios.executor import run_sweep

SWEEP_OUT = "BENCH_torch_sweep.json"
RUN_OUT = "BENCH_torch_run.json"


def _default_jobs(device: str) -> int:
    """Inline on a card (each pool worker would open its own CUDA context on
    it, and their host seconds would contend); up to 4 workers on the CPU."""
    if device.startswith("cuda"):
        return 1
    return min(4, os.cpu_count() or 1)


def _print_list() -> None:
    print("presets:")
    for name, spec in sorted(presets_lib.all_presets().items()):
        print(f"  {name:<24} task={spec.task:<9} H={spec.hospitals:<3} "
              f"size={spec.model_size:<7} tags={','.join(spec.tags)}")
    print("\nsweeps:")
    for name in sorted(grid_lib.SWEEPS):
        g = grid_lib.get_sweep(name)
        axes = ", ".join(f"{k}x{len(v)}" for k, v in sorted(g.axes.items()))
        print(f"  {name:<24} {g.size():>4} cells  ({axes})")


def _emit_artifacts(out_path: str, sweep_name: str, cells) -> None:
    out_json, out_md = report_lib.write_artifacts(sweep_name, cells, out_path)
    print(report_lib.markdown_report(sweep_name, cells))
    print(f"wrote {out_json} and {out_md}", file=sys.stderr)


def _sweep_cells(args, specs, sweep_name: str, default_out: str) -> int:
    cache = ResultCache(args.cache_dir)
    outcome = run_sweep(
        specs, cache,
        jobs=args.jobs if args.jobs is not None else _default_jobs(
            args.device),
        force=args.force,
        progress=lambda msg: print(msg, file=sys.stderr),
        device=args.device,
    )
    print(f"sweep {sweep_name}: {outcome.cells} cells "
          f"({outcome.hits} cached, {outcome.misses} ran) "
          f"in {outcome.elapsed:.1f}s", file=sys.stderr)
    _emit_artifacts(args.out or default_out, sweep_name, outcome.results)
    if args.assert_cached and outcome.misses:
        print(f"--assert-cached: {outcome.misses} cells were NOT served "
              "from cache", file=sys.stderr)
        return 1
    return 0


def _export_obs(args) -> None:
    if args.obs and obs.recorder() is not None:
        paths = obs.export(args.obs)
        obs.disable()
        print(f"obs: wrote {', '.join(str(v) for v in paths.values())}",
              file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="Declarative scenario suite + cached parallel sweeps.",
    )
    act = p.add_mutually_exclusive_group(required=True)
    act.add_argument("--list", action="store_true",
                     help="list presets and named sweeps")
    act.add_argument("--run", metavar="PRESET",
                     help="run one named preset (through the cache)")
    act.add_argument("--sweep", metavar="SWEEP",
                     help="run a named sweep (only cache misses execute)")
    act.add_argument("--report", metavar="SWEEP",
                     help="re-render a sweep's artifacts from cache only")
    p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                   help=f"result cache directory (default {DEFAULT_CACHE_DIR})")
    p.add_argument("--jobs", type=int, default=None,
                   help="process-pool width for cache misses (1 = inline; "
                        "default 1 on a cuda device, where every worker "
                        "would open its own context on the one card, and "
                        "min(4, CPUs) on the cpu)")
    p.add_argument("--out", default=None,
                   help=f"artifact path, markdown lands beside it (default: "
                        f"{SWEEP_OUT} for --sweep/--report, {RUN_OUT} for "
                        f"--run — so one-off runs never clobber a sweep's, "
                        f"and neither the reference's)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; pool workers use it too")
    p.add_argument("--force", action="store_true",
                   help="ignore cached results and re-run every cell")
    p.add_argument("--assert-cached", action="store_true",
                   help="exit 1 if any cell had to execute (CI cache check)")
    p.add_argument("--arm", help="override the arm for --run")
    p.add_argument("--obs", default=None, metavar="DIR",
                   help="record obs spans (per-cell phase breakdowns in the "
                        "BENCH rows) and export artifacts into DIR; "
                        "inline cells only — pool workers do not record")
    args = p.parse_args(argv)
    if args.obs:
        obs.enable()

    if args.list:
        _print_list()
        return 0

    if args.run:
        spec = presets_lib.get_preset(args.run)
        if args.arm:
            spec = spec.replace(arm=args.arm,
                                name=f"{spec.name}/arm={args.arm}")
        rc = _sweep_cells(args, [spec], spec.name, RUN_OUT)
        _export_obs(args)
        return rc

    if args.sweep:
        specs = grid_lib.get_sweep(args.sweep).specs()
        rc = _sweep_cells(args, specs, args.sweep, SWEEP_OUT)
        _export_obs(args)
        return rc

    # --report: cache-only re-render
    sweep = grid_lib.get_sweep(args.report)
    cache = ResultCache(args.cache_dir)
    cells, missing = [], []
    for spec in sweep.specs():
        cached = cache.get(spec)
        (cells.append(cached) if cached is not None
         else missing.append(spec.name))
    if missing:
        print(f"{len(missing)} of {sweep.size()} cells are not cached "
              f"(first: {missing[0]}); run --sweep {args.report} first",
              file=sys.stderr)
        return 1
    _emit_artifacts(args.out or SWEEP_OUT, args.report, cells)
    return 0

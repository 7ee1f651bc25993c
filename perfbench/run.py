#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``perfbench/`` and
the port under ``src/`` (put on the path here).  It refuses to run
without enough CUDA cards for the cell.  It sets up the cell (its
configuration, traffic mix and driver are found by the names in
``BENCHMARK.json``), measures for ``--seconds``, judges the outputs
against the plain reference, and prints the numbers it compared beside
their limits as the last lines of standard error and one JSON object as
the last line of standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics, the device's busy seconds and a
breakdown with ``--trace 1``.

Build and kernel caches stay in fixed directories of the checkout
(``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is the port)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench.harness import spec
    from perfbench.harness.cell import run_cell

    chips = spec.workload(spec.benchmark(ROOT), args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {cards}: nothing measured", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)}: the port "
              "must not use JAX or the JAX package", file=sys.stderr)
        return 3
    result = out["result"]
    for note in out["notes"]:
        print(f"perfbench: {note}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--variants tf32,bf16,fp8,half,frozen] [--seconds 1] [--out FILE]

For each seed, one run of the cell with a short window, in one process:
the numbers the program reads against the plain reference (the lower
readings), and with ``--variants`` the same numbers read by the controls,
the reference put in the program's place with every product's operands
(and, for ``tf32`` and ``bf16``, the gradient before each backward
product) in TF32 (``tf32``: float32's next step down, the training
window's control), bfloat16 (``bf16``) or float8 e4m3 (``fp8``: bf16's
next step down, round 0's and evaluation's control), and by planted
faults: the reference keeping half of each hospital's draw (``half``),
and a step that leaves the weights as they were (``frozen``, read from the
noise alone).  One JSON line per seed on standard output, and in
``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench import run as bench_run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    bench_run._environment()
    from perfbench.harness.cell import run_cell

    variants = tuple(v for v in args.variants.split(",") if v)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(args.workload, seed, args.seconds, False,
                       t_start=t0, variants=variants)
        res = out["result"]
        line = {"workload": args.workload, "seed": seed,
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "variants": out["variants"], "readings": out["readings"],
                "setup_s": res["metrics"]["setup_s"]["value"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Trace one dry-run cell at a cut depth, with its no-DP twin if asked.

    python3 tools/dryrun_cell.py ARCH SHAPE MESH [--dp-mode MODE]
        [--layers N] [--microbatch M] [--twin] [--out DIR] [--src CHECKOUT]

MESH is "D,M" ("data", "model") or "P,D,M" ("pod", "data", "model"),
e.g. 2,16,16; "1,1" is one rank.  ``--layers N`` keeps N repeats of
each of the arch's layer groups (``run_one``'s ``cfg_overrides``: the
stack and ``n_layers``); ``--microbatch M`` sets ``dp_microbatch``.
``--twin`` traces the ``--dp-mode none`` program at the same cut as
well.  Each program is a process of its own (a ``fake`` group of the
mesh's size) of ``CHECKOUT/src`` (default: this checkout); nothing is
allocated.  Prints each record's FLOPs, collective bytes and trace
seconds, and with ``--twin`` their ratio, as one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CELL = r"""
import json, math, sys
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import init_fake_group, make_mesh

arch, shape, mesh, mode, layers, micro, out = sys.argv[1:8]
dims = tuple(int(n) for n in mesh.split(","))
init_fake_group(math.prod(dims))
over = {}
if int(layers):
    stack = tuple((min(int(layers), r), p) for r, p in get_config(arch).stack)
    over = {"stack": stack, "n_layers": sum(r * len(p) for r, p in stack)}
if int(micro):
    over["dp_microbatch"] = int(micro)
rec = run_one(arch, shape, mesh=make_mesh(dims, ("pod", "data", "model")[
    -len(dims):], "cpu"), dp_mode=None if mode == "-" else mode,
    out_dir=out, tag=mode if mode != "-" else "", cfg_overrides=over)
print("RECORD::" + json.dumps({k: rec[k] for k in (
    "arch", "shape", "mesh", "flops", "collective_bytes", "trace_s",
    "model_flops")} | {"dp_mode": rec["meta"].get("dp_mode"),
                        "n_layers": get_config(arch).replace(**over).n_layers}))
"""


def trace(args, mode: str, out: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CELL, args.arch, args.shape, args.mesh, mode,
         str(args.layers), str(args.microbatch), out],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(Path(args.src) / "src")))
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RECORD::")]
    if proc.returncode or not lines:
        sys.exit(f"{args.arch} {args.shape} {args.mesh} {mode}: exit "
                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(lines[0][len("RECORD::"):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("arch")
    p.add_argument("shape")
    p.add_argument("mesh")
    p.add_argument("--dp-mode", default="-")
    p.add_argument("--layers", type=int, default=0)
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--twin", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--src", default=str(ROOT))
    args = p.parse_args(argv)
    out = args.out or tempfile.mkdtemp(prefix="dryrun_cell_")
    rec = trace(args, args.dp_mode, out)
    print(json.dumps(rec))
    if args.twin:
        twin = trace(args, "none", out)
        print(json.dumps(twin))
        pods = int(args.mesh.split(",")[0]) if args.mesh.count(",") == 2 \
            else 1
        print(json.dumps({"ratio": rec["flops"] / twin["flops"],
                          "bar": 1.25 * pods}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

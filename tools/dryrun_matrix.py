#!/usr/bin/env python3
"""Run the port's dry-run matrix, one process a cell, and print its table.

    python3 tools/dryrun_matrix.py [--out DIR] [--jobs N] [--src CHECKOUT]
                                   [--only ARCH ...] [--no-twins]

Each cell is ``python -m repro_torch.launch.dryrun --arch A --shape S
[--multi-pod]`` of ``CHECKOUT/src`` (default: this checkout), a ``fake``
group of its own: the 10 archs x 4 shapes on the (16, 16) mesh and, with
``--multi-pod``, on (2, 16, 16), and the ``--dp-mode none`` twin (tag
``none``) of every ``train_4k`` cell whose per-example program takes the
per-example activation rules (a microbatch that the mesh's ("pod",
"data") ranks do not divide: every arch on (2, 16, 16), the
``dp_microbatch=1`` archs on (16, 16)).  ``N`` cells run at once (default
7), the longest first.  Nothing is allocated: every cell traces meta
DTensors on the CPU, under whichever torch runs it.

Prints one line per cell as it ends, then a markdown table (arch, shape,
mesh, trace s, FLOPs, collective bytes, bottleneck; SKIP or FAIL), then
for each per-example-rules cell its FLOPs beside its twin's, their ratio
and the bar (1.25 x the mesh's "pod" extent), and a JSON line with the
counts.  Exits 1 if a cell fails (other than a ``ShapeSkip``) or a ratio
breaks its bar.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("rwkv6-3b", "jamba-v0.1-52b", "deepseek-v3-671b", "nemotron-4-340b",
         "qwen3-moe-30b-a3b", "qwen2-vl-2b", "whisper-small", "smollm-360m",
         "gemma-7b", "olmo-1b")          # about the longest first
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the archs whose dp_microbatch is 1: per-example rules on (16, 16) too
MICRO_ONE = ("qwen3-moe-30b-a3b", "nemotron-4-340b", "jamba-v0.1-52b",
             "deepseek-v3-671b")
BAR = 1.25


def cells(archs) -> list[tuple]:
    """(arch, shape, multi_pod, dp_mode) of the matrix and the twins."""
    out = [(a, s, mp, None) for a in archs for s in SHAPES
           for mp in (True, False)]
    out += [(a, "train_4k", True, "none") for a in archs]
    out += [(a, "train_4k", False, "none") for a in archs if a in MICRO_ONE]
    return out


def run_cell(cell, out: str, src: str) -> dict:
    arch, shape, multi_pod, mode = cell
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--out", out]
    if multi_pod:
        argv.append("--multi-pod")
    if mode:
        argv += ["--dp-mode", mode, "--tag", mode]
    name = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}" \
        + (f"__{mode}" if mode else "")
    log = Path(out) / "logs" / f"{name}.log"
    t0 = time.time()
    with open(log, "w") as f:
        rc = subprocess.run(argv, stdout=f, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=src)).returncode
    text = log.read_text()
    status = "SKIP" if rc == 0 and "SKIP:" in text else \
        ("OK" if rc == 0 else "FAIL")
    rec = None
    if status == "OK":
        rec = json.loads((Path(out) / f"{name}.json").read_text())
    why = ""
    if status != "OK":
        lines = [ln for ln in text.splitlines()
                 if "SKIP:" in ln or "FAIL:" in ln]
        why = lines[0] if lines else text.strip().splitlines()[-1:]
    res = {"cell": cell, "name": name, "status": status, "rc": rc,
           "wall_s": time.time() - t0, "record": rec, "why": str(why)}
    print(f"{name}: {status} ({res['wall_s']:.1f} s)"
          + (f" flops={rec['flops']:.4e}" if rec else f" {why}"),
          flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(ROOT / "build" / "dryrun_matrix"))
    p.add_argument("--jobs", type=int, default=7)
    p.add_argument("--src", default=str(ROOT))
    p.add_argument("--only", nargs="*", default=None)
    p.add_argument("--no-twins", action="store_true")
    args = p.parse_args(argv)

    import torch

    print(f"torch {torch.__version__}, python {sys.version.split()[0]}",
          flush=True)
    archs = [a for a in ARCHS if not args.only or a in args.only]
    todo = [c for c in cells(archs) if not (args.no_twins and c[3])]
    os.makedirs(Path(args.out) / "logs", exist_ok=True)
    for f in glob.glob(str(Path(args.out) / "*.json")):
        os.remove(f)
    src = str(Path(args.src) / "src")
    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda c: run_cell(c, args.out, src), todo))
    wall = time.time() - t0

    print("\n| arch | shape | mesh | trace s | FLOPs | coll B | bottleneck |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        if r["cell"][3]:
            continue
        arch, shape, mp, _ = r["cell"]
        mesh = "2x16x16" if mp else "16x16"
        rec = r["record"]
        if rec is None:
            print(f"| {arch} | {shape} | {mesh} | {r['status']} | — | — | "
                  f"{r['why'][:60]} |")
            continue
        print(f"| {arch} | {shape} | {mesh} | {rec['trace_s']:.1f} | "
              f"{rec['flops']:.3e} | {rec['collective_bytes']:.3e} | "
              f"{rec['roofline']['bottleneck']} |")

    by = {r["cell"]: r for r in results}
    bad = [r["name"] for r in results if r["status"] == "FAIL"]
    ratios = {}
    print("\n| arch | mesh | per-example FLOPs | none FLOPs | ratio | bar |")
    print("|---|---|---|---|---|---|")
    for (arch, shape, mp, mode), twin in by.items():
        if mode != "none":
            continue
        pe = by.get((arch, shape, mp, None))
        if pe is None or pe["record"] is None or twin["record"] is None:
            continue
        bar = BAR * (2 if mp else 1)
        ratio = pe["record"]["flops"] / twin["record"]["flops"]
        ratios[pe["name"]] = ratio
        if ratio > bar:
            bad.append(pe["name"] + " ratio")
        print(f"| {arch} | {'2x16x16' if mp else '16x16'} | "
              f"{pe['record']['flops']:.4e} | {twin['record']['flops']:.4e} "
              f"| {ratio:.3f} | {bar:.2f} |")
    counts = {s: sum(r["status"] == s for r in results if not r["cell"][3])
              for s in ("OK", "SKIP", "FAIL")}
    print(json.dumps({"torch": torch.__version__, "cells": counts,
                      "twins_failed": sum(r["status"] == "FAIL"
                                          for r in results if r["cell"][3]),
                      "ratios": ratios, "wall_s": round(wall, 1),
                      "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

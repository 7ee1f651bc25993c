#!/usr/bin/env python3
"""One cell, run untraced, traced as the benchmark traces it, and traced
through the port's device-timed spans (``harness.spans.SpanTrace``), each
mode a whole run of the cell in turn in one process.

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> \\
        [--seconds 16] [--modes off,trace,spans] [--out FILE]

Not a run of the benchmark: ``run.py`` is.  This reads what the benchmark's
drivers cannot read yet, since they trace with ``harness.trace.Trace``:
the span-read metrics (``metrics/real_rows.train.py``, ``clip_ms.train``,
``loss_ms.eval``), each span's device seconds, the share of the device's
busy time inside top-level spans, where the clipping and attention
kernels ran, and how far the device clock and the profiler's clock
disagree (over the window, and at the worst anchor).  Each mode
prints one JSON line: its end-to-end rate (the cost of tracing is the
traced rates against ``off``), the cell's per-layer metrics where traced,
the breakdown, and the numbers ``correct`` compares beside their limits.
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

SPAN_METRICS = ("real_rows.train", "clip_ms.train", "loss_ms.eval")
# (what, kernels, inside the spans, outside the spans)
PLACEMENTS = (
    ("ghost_norm_in_clip", ("ghost_norm",), ("clip",), ()),
    ("flash_in_loss_fn_not_loss", ("flash_attention",), ("model.loss_fn",),
     ("model.loss",)),
)


def run_mode(name: str, seed: int, seconds: float, mode: str) -> dict:
    import torch

    from perfbench.harness import checks, spec
    from perfbench.harness.cell import Job
    from perfbench.harness.spans import SpanTrace
    from perfbench.harness.trace import Trace

    t_start = time.perf_counter()
    bench = spec.benchmark()
    cell = spec.workload(bench, name)
    mc, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    drv = spec.driver(mix["kind"])
    drv.Trace = SpanTrace if mode == "spans" else Trace
    job = Job(mc, mix, seed, seconds, mode != "off", "cuda", t_start,
              spec.reference(mix["kind"]))
    out = drv.run(job)
    ctx = out["ctx"]
    line = {"workload": name, "seed": seed, "mode": mode,
            "device": torch.cuda.get_device_name(0),
            "setup_s": out["setup_s"], "window_s": ctx["window_s"],
            **out["end_to_end"], "notes": out["notes"],
            "checks": checks.judge(out["numbers"], spec.limits(name))[1]}
    summary = ctx.get("trace")
    if summary is None:
        return line
    names = [m["name"] for m in spec.per_layer(bench, name)]
    line["per_layer"] = {m: spec.metric_reader(m).read(ctx)
                         for m in names + list(SPAN_METRICS)}
    line.update(busy_s=summary.busy_s, trace_window_s=summary.window_s,
                breakdown=summary.breakdown())
    if mode == "spans":
        line.update(
            covered_share=summary.covered_s / summary.busy_s,
            clock_skew_us=summary.clock_skew_us,
            counters=summary.counters,
            device_s_by_span=summary.device_s_by_span,
            clock_warp_us=summary.clock_warp_us, anchors=summary.anchors,
            placements={what: summary.kernel_share(k, inside, outside)
                        for what, k, inside, outside in PLACEMENTS})
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=16.0)
    ap.add_argument("--modes", default="off,trace,spans")
    ap.add_argument("--out")
    args = ap.parse_args()
    bench_run._environment()
    for mode in args.modes.split(","):
        line = run_mode(args.workload, args.seed, args.seconds, mode)
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: find its parts, drive it, read its metrics, judge
its outputs.  ``run.py`` prints what ``run_cell`` returns; the tests call
it on the CPU at small widths."""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from perfbench.harness import checks, spec


@dataclasses.dataclass
class Job:
    mc: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    reference: Any
    variants: tuple[str, ...] = ()


def device_info(device: str, chips: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             config_overrides: dict | None = None,
             mix_overrides: dict | None = None,
             variants: tuple[str, ...] = ()) -> dict:
    """The result of one run: the contract's keys, and ``checks`` last.
    ``config_overrides``/``mix_overrides`` are for tests at small widths;
    ``variants`` adds the control's and the planted faults' numbers
    (``control.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.benchmark()
    cell = spec.workload(bench, name)
    mc = {**spec.config(cell["config"]), **(config_overrides or {})}
    mix = {**spec.traffic(cell["traffic"]), **(mix_overrides or {})}
    kind = mix["kind"]
    job = Job(mc, mix, int(seed), float(seconds), bool(trace), device,
              t_start, spec.reference(kind), tuple(variants))
    out = spec.driver(kind).run(job)
    names = {m["name"] for m in spec.end_to_end(bench, name)}
    values = {"setup_s": out["setup_s"], **out["end_to_end"]}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if trace:
        metrics = {}
        for m in spec.per_layer(bench, name):
            value = spec.metric_reader(m["name"]).read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {k: {"value": values[k], "unit": units[k]}
                   for k in units if k in names}
    ok, shown = checks.judge(out["numbers"], spec.limits(name))
    result = {
        "correct": ok, "attempted": out["attempted"],
        "failed": out["failed"], "metrics": metrics,
        "device": {**device_info(device, cell["chips"]),
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    summary = out["ctx"].get("trace")
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["checks"] = shown
    return {"result": result, "notes": out["notes"],
            "variants": out["variants"], "readings": out["readings"]}

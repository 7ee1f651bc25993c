"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

    configs/<config>.json     the configuration as it is run
    traffic/<mix>.json        a traffic mix; its ``kind`` names the driver
    drivers/<kind>.py         runs one cell of that kind: set-up, window
    reference/<kind>.py       the plain reference that judges that kind
    metrics/<metric>.py       one per-layer metric: ``read(ctx)``
    limits/<cell>.json        the limit of each number ``correct`` compares

A new configuration, mix, kind or metric is new files and new entries in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(c['name'] for c in bench['workloads'])})")


def _json(kind: str, name: str) -> dict:
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def _module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` loaded by its path (a metric's name holds dots,
    so it is no importable module name)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(path)
    key = f"perfbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    return _module("drivers", kind)


def reference(kind: str) -> ModuleType:
    return _module("reference", kind)


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def end_to_end(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics reported in ``cell``: those that list it."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]

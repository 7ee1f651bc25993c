"""JSONL event stream -> Chrome trace (``chrome://tracing`` / Perfetto).

The port's own copy of ``repro.obs.convert``.  Output is the Trace Event
Format's JSON-object flavour, ``{"traceEvents": [...], "displayTimeUnit":
"ms"}``, with spans as complete (``"ph": "X"``) events in microseconds,
counters and gauges as ``"ph": "C"`` series, and thread-name metadata
(``"ph": "M"``) naming each thread by its first span.  Stdlib only.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence


def chrome_trace(events: Sequence[Mapping]) -> dict:
    """Convert recorder events to a Chrome trace dict.  Unknown event
    types are skipped, so streams from newer schema versions still load."""
    pid = os.getpid()
    out: list[dict] = []
    thread_names: dict[int, str] = {}
    for ev in events:
        etype = ev.get("type")
        if etype == "meta":
            pid = ev.get("pid", pid)
        elif etype == "span":
            tid = ev.get("tid", 0)
            thread_names.setdefault(tid, f"thread ({ev['name']})")
            out.append({
                "name": ev["name"], "ph": "X", "cat": ev.get("cat", "obs"),
                "ts": ev["ts"] * 1e6, "dur": ev["dur"] * 1e6,
                "pid": pid, "tid": tid, "args": ev.get("args", {}),
            })
        elif etype == "counter":
            out.append({
                "name": ev["name"], "ph": "C", "cat": "counter",
                "ts": ev["ts"] * 1e6, "pid": pid, "tid": 0,
                "args": {ev["name"]: ev["total"]},
            })
        elif etype == "gauge":
            out.append({
                "name": ev["name"], "ph": "C", "cat": "gauge",
                "ts": ev["ts"] * 1e6, "pid": pid, "tid": 0,
                "args": {ev["name"]: ev["value"]},
            })
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": name}}
        for tid, name in sorted(thread_names.items())
    ]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Sequence[Mapping],
                       path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f)


def validate_chrome_trace(path: str | os.PathLike) -> dict:
    """Light structural check of an exported trace file."""
    with open(path) as f:
        payload = json.load(f)
    evs = payload.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError(f"{path}: no traceEvents list")
    for i, ev in enumerate(evs):
        if "ph" not in ev or "pid" not in ev:
            raise ValueError(f"{path}: traceEvents[{i}] missing ph/pid")
        if ev["ph"] == "X" and (ev.get("dur", -1.0) < 0 or "ts" not in ev):
            raise ValueError(f"{path}: traceEvents[{i}] bad complete event")
    return {"trace_events": len(evs)}

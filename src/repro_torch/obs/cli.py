"""``python -m repro_torch.obs`` — summarize / validate / convert obs artifacts.

Counterpart of ``repro.obs.cli``, over the port's ``obs``: the same exit
codes and the same text, and each package's CLI reads the other's
artifacts.

Examples::

    # human summary of an export directory (events + ledger)
    python -m repro_torch.obs obs_out

    # CI gate: structural validation of the event stream, the ledger's
    # content-hash chain, and (when present) the Chrome trace
    python -m repro_torch.obs --validate obs_out

    # convert a raw event stream to a Perfetto/chrome://tracing file
    python -m repro_torch.obs --to-chrome obs_out/events.jsonl --out trace.json

Paths may be export directories (containing ``events.jsonl`` /
``ledger.jsonl`` / ``trace.json``) or individual files; directories
validate every artifact they contain.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.obs import (
    EVENTS_FILE,
    LEDGER_FILE,
    TRACE_FILE,
    per_hospital_epsilon,
    read_entries,
    read_events,
    validate_entries,
    validate_events,
    write_chrome_trace,
)
from repro_torch.obs.convert import validate_chrome_trace
from repro_torch.obs.ledger import bytes_by_hospital


def _artifacts(path: Path) -> dict[str, Path]:
    """Map a CLI path to the artifact files it names."""
    if path.is_dir():
        found = {}
        for key, name in (("events", EVENTS_FILE), ("ledger", LEDGER_FILE),
                          ("trace", TRACE_FILE)):
            if (path / name).exists():
                found[key] = path / name
        if not found:
            raise FileNotFoundError(
                f"{path}: no obs artifacts ({EVENTS_FILE}/{LEDGER_FILE}/"
                f"{TRACE_FILE}) found")
        return found
    if path.name == LEDGER_FILE or "ledger" in path.name:
        return {"ledger": path}
    if path.suffix == ".json":
        return {"trace": path}
    return {"events": path}


def _validate_one(path: Path) -> list[str]:
    lines = []
    arts = _artifacts(path)
    if "events" in arts:
        summary = validate_events(read_events(arts["events"]))
        lines.append(f"{arts['events']}: OK — {summary['events']} events "
                     f"{summary['by_type']}")
    if "ledger" in arts:
        summary = validate_entries(read_entries(arts["ledger"]))
        lines.append(
            f"{arts['ledger']}: OK — chain of {summary['entries']} entries "
            f"({summary['hospitals']} hospitals x {summary['rounds']} "
            f"rounds), head {summary['head']}")
    if "trace" in arts:
        summary = validate_chrome_trace(arts["trace"])
        lines.append(f"{arts['trace']}: OK — {summary['trace_events']} "
                     "trace events")
    return lines


def _summarize_one(path: Path) -> list[str]:
    lines = []
    arts = _artifacts(path)
    if "events" in arts:
        events = read_events(arts["events"])
        spans: dict[str, tuple[int, float]] = {}
        counters: dict[str, float] = {}
        for ev in events:
            if ev.get("type") == "span":
                n, s = spans.get(ev["name"], (0, 0.0))
                spans[ev["name"]] = (n + 1, s + ev["dur"])
            elif ev.get("type") == "counter":
                counters[ev["name"]] = ev["total"]
        lines.append(f"{arts['events']}: {len(events)} events")
        for name, (n, total) in sorted(spans.items(),
                                       key=lambda kv: -kv[1][1]):
            lines.append(f"  span    {name:<28} x{n:<6} {total:9.4f}s")
        for name, total in sorted(counters.items()):
            lines.append(f"  counter {name:<28} {total:g}")
    if "ledger" in arts:
        entries = read_entries(arts["ledger"])
        eps = per_hospital_epsilon(entries)
        by = bytes_by_hospital(entries)
        lines.append(f"{arts['ledger']}: {len(entries)} entries")
        for hosp in sorted(eps):
            lines.append(f"  hospital {hosp:<4} eps={eps[hosp]:10.4f}  "
                         f"bytes_up={by.get(hosp, 0.0):12.0f}")
    return lines


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="summarize / validate / convert repro_torch.obs artifacts",
    )
    p.add_argument("paths", nargs="*", type=Path,
                   help="export directories or artifact files")
    p.add_argument("--validate", action="store_true",
                   help="validate event streams, ledger hash chains, and "
                        "Chrome traces; exit 1 on the first violation")
    p.add_argument("--to-chrome", type=Path, metavar="EVENTS",
                   help="convert an events.jsonl to a Chrome trace")
    p.add_argument("--out", type=Path, default=Path("trace.json"),
                   help="output path for --to-chrome")
    args = p.parse_args(argv)

    if args.to_chrome is not None:
        write_chrome_trace(read_events(args.to_chrome), args.out)
        print(f"wrote {args.out}")
        return 0
    if not args.paths:
        p.error("need at least one path (or --to-chrome)")
    rc = 0
    for path in args.paths:
        try:
            lines = (_validate_one if args.validate else _summarize_one)(path)
        except Exception as e:  # noqa: BLE001 - CLI reports, exit code gates
            print(f"{path}: FAILED — {e}", file=sys.stderr)
            rc = 1
            continue
        print("\n".join(lines))
    return rc

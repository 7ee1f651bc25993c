"""Scaling-law analysis over sweep cells + report/artifact emission.

Counterpart of ``repro.scenarios.report``, the same fits and the same
markdown for the same rows.

Fits log-log least-squares power laws per arm from the sweep's cells:

  * simulated wall-clock vs cohort size H   (``wall ∝ H^b``)
  * bytes-on-wire vs cohort size H
  * bytes-on-wire vs model parameter count  (when the sweep varies size)

and renders a markdown report (scaling-law tables + the raw cell table)
plus the ``BENCH_torch_sweep.json`` artifact — the repo's perf
trajectory for the ROADMAP's capacity-planning item.

Pure stdlib: fitting two-point-or-more lines in log space needs no numpy,
and the report path stays importable without torch.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Sequence


def fit_power_law(xs: Sequence[float], ys: Sequence[float]) -> dict | None:
    """Least-squares fit of ``y = a * x^b`` in log-log space.

    Points with a non-positive x or y are dropped (logs undefined — e.g. a
    zero-traffic arm).  Returns {"exponent", "coefficient", "r2", "points"}
    over the surviving points, or None when fewer than two distinct x
    values survive.
    """
    pts = [(x, y) for x, y in zip(xs, ys) if x > 0 and y > 0]
    if len({x for x, _ in pts}) < 2:
        return None
    lx = [math.log(x) for x, _ in pts]
    ly = [math.log(y) for _, y in pts]
    n = len(pts)
    mx, my = sum(lx) / n, sum(ly) / n
    var = sum((x - mx) ** 2 for x in lx)
    b = sum((x - mx) * (y - my) for x, y in zip(lx, ly)) / var
    a = my - b * mx
    ss_res = sum((y - (a + b * x)) ** 2 for x, y in zip(lx, ly))
    ss_tot = sum((y - my) ** 2 for y in ly)
    r2 = 1.0 if ss_tot == 0 else 1.0 - ss_res / ss_tot
    return {"exponent": b, "coefficient": math.exp(a), "r2": r2, "points": n}


# Metrics averaged (with a CI) across a multi-seed axis; everything else in
# a seed group must agree or the group is not a seed group.
_SEED_METRICS = ("epsilon", "accuracy", "mean_loss", "wall_clock",
                 "bytes_on_wire", "rounds_completed", "recoveries",
                 "lost_rounds", "dropout_events", "noise_topups",
                 "host_seconds")
_GROUP_KEYS = ("task", "arm", "backend", "hospitals", "model_size",
               "model_params")


def aggregate_seeds(cells: Sequence[dict]) -> list[dict]:
    """Collapse a sweep's seed axis: one row per (task, arm, backend, H,
    model size), metrics averaged with a 95% normal CI half-width
    (``<metric>_ci`` = 1.96 * sd / sqrt(n); omitted for singleton groups).

    Cells missing a group key (foreign payloads) pass through untouched.
    Output rows carry ``seeds`` (the group size); power-law fits run over
    these group means, which for singleton groups reproduces the ungrouped
    fit exactly.
    """
    groups: dict[tuple, list[dict]] = {}
    passthrough: list[dict] = []
    for c in cells:
        if any(k not in c for k in _GROUP_KEYS):
            passthrough.append(dict(c))
            continue
        groups.setdefault(tuple(c[k] for k in _GROUP_KEYS), []).append(c)
    out: list[dict] = []
    for key, rows in groups.items():
        row = dict(rows[0])
        row["seeds"] = len(rows)
        if len(rows) > 1:
            # strip the seed-specific label; the group keys identify the row
            row["name"] = "{}/{}".format(
                rows[0].get("name", "").split("/")[0] or rows[0]["arm"],
                ",".join(f"{k}={v}" for k, v in zip(_GROUP_KEYS, key)
                         if k in ("arm", "hospitals", "model_size")),
            )
            for m in _SEED_METRICS:
                vals = [r[m] for r in rows
                        if isinstance(r.get(m), (int, float))]
                if len(vals) != len(rows):
                    continue  # a None (NaN mean_loss) voids the average
                n = len(vals)
                mean = sum(vals) / n
                sd = math.sqrt(sum((v - mean) ** 2 for v in vals) / (n - 1))
                row[m] = mean
                row[m + "_ci"] = 1.96 * sd / math.sqrt(n)
        out.append(row)
    out.extend(passthrough)
    return out


def _fit_by_arm(cells: list[dict], x_key: str, y_key: str) -> dict[str, dict]:
    arms = sorted({c["arm"] for c in cells})
    out = {}
    for arm in arms:
        rows = [c for c in cells if c["arm"] == arm]
        fit = fit_power_law([c[x_key] for c in rows],
                            [c[y_key] for c in rows])
        if fit is not None:
            out[arm] = fit
    return out


def scaling_laws(cells: Sequence[dict]) -> dict:
    """All fits the sweep's cells support, keyed by law name.

    Systems laws fit over cells that carried a simulated-time story (any
    backend whose runs advanced a simulated clock — zero-traffic arms like
    ``local`` still count), not a hardcoded backend name.  The seed axis is
    collapsed first (``aggregate_seeds``): fits run over per-group means so
    a sweep with 3 seeds per cell contributes one point per cell, not three
    coincident ones that would overweight replicated configurations.
    """
    sim = [c for c in aggregate_seeds(cells) if c.get("wall_clock", 0) > 0]
    return {
        "wall_clock_vs_hospitals": _fit_by_arm(sim, "hospitals", "wall_clock"),
        "bytes_vs_hospitals": _fit_by_arm(sim, "hospitals", "bytes_on_wire"),
        "bytes_vs_model_params": _fit_by_arm(sim, "model_params",
                                             "bytes_on_wire"),
    }


_LAW_TITLES = {
    "wall_clock_vs_hospitals": ("Simulated wall-clock vs cohort size",
                                "wall ∝ H^b"),
    "bytes_vs_hospitals": ("Bytes on wire vs cohort size", "bytes ∝ H^b"),
    "bytes_vs_model_params": ("Bytes on wire vs model size",
                              "bytes ∝ params^b"),
}


def markdown_report(sweep_name: str, cells: Sequence[dict],
                    laws: dict | None = None) -> str:
    """The human-readable sweep report (scaling laws + cell table)."""
    laws = laws if laws is not None else scaling_laws(cells)
    lines = [f"# Sweep `{sweep_name}` — {len(cells)} cells", ""]
    for law, fits in laws.items():
        title, form = _LAW_TITLES.get(law, (law, "y ∝ x^b"))
        if not fits:
            continue
        lines += [f"## {title} ({form})", "",
                  "| arm | exponent b | coefficient a | R² | cells |",
                  "|---|---|---|---|---|"]
        for arm, fit in sorted(fits.items()):
            lines.append(
                f"| {arm} | {fit['exponent']:.3f} | "
                f"{fit['coefficient']:.4g} | {fit['r2']:.3f} | "
                f"{fit['points']} |"
            )
        lines.append("")
    grouped = [g for g in aggregate_seeds(cells) if g.get("seeds", 1) > 1]
    if grouped:
        lines += ["## Seed groups (mean ± 95% CI)", "",
                  "| group | arm | H | seeds | ε | utility | "
                  "sim wall (s) | bytes |",
                  "|---|---|---|---|---|---|---|---|"]

        def pm(g: dict, m: str, fmt: str) -> str:
            ci = g.get(m + "_ci")
            base = format(g[m], fmt)
            return base if ci is None else f"{base} ± {format(ci, fmt)}"

        for g in grouped:
            lines.append(
                f"| {g['name']} | {g['arm']} | {g['hospitals']} | "
                f"{g['seeds']} | {pm(g, 'epsilon', '.2f')} | "
                f"{pm(g, 'accuracy', '.3f')} | "
                f"{pm(g, 'wall_clock', '.3f')} | "
                f"{pm(g, 'bytes_on_wire', '.3g')} |"
            )
        lines.append("")
    lines += ["## Cells", "",
              "| cell | arm | H | size | rounds | ε | utility | "
              "sim wall (s) | host (s) | bytes | recov | topups |",
              "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        # sim wall vs host seconds side by side: the simulated federation
        # clock tells the systems story, host seconds what the sweep paid;
        # .get() keeps pre-topup cached cells renderable
        host = c.get("host_seconds")
        lines.append(
            f"| {c['name']} | {c['arm']} | {c['hospitals']} | "
            f"{c['model_size']} | {c['rounds_completed']} | "
            f"{c['epsilon']:.2f} | {c['accuracy']:.3f} | "
            f"{c['wall_clock']:.3f} | "
            f"{'-' if host is None else format(host, '.3f')} | "
            f"{c['bytes_on_wire']:.0f} | {c['recoveries']} | "
            f"{c.get('noise_topups', '-')} |"
        )
    lines.append("")
    return "\n".join(lines)


def bench_payload(sweep_name: str, cells: Sequence[dict],
                  laws: dict | None = None) -> dict:
    """The ``BENCH_torch_sweep.json`` structure."""
    return {
        "sweep": sweep_name,
        "cells": list(cells),
        "seed_groups": aggregate_seeds(cells),
        "scaling_laws": laws if laws is not None else scaling_laws(cells),
        "generated_by": "python -m repro_torch.scenarios",
    }


def write_artifacts(sweep_name: str, cells: Sequence[dict],
                    out_json: str | Path) -> tuple[Path, Path]:
    """Write the JSON artifact + the sibling .md; returns both paths."""
    laws = scaling_laws(cells)
    out_json = Path(out_json)
    out_json.write_text(
        json.dumps(bench_payload(sweep_name, cells, laws), indent=2,
                   sort_keys=True)
    )
    out_md = out_json.with_suffix(".md")
    out_md.write_text(markdown_report(sweep_name, cells, laws))
    return out_json, out_md

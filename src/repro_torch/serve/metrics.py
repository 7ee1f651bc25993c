"""Serving metrics: latency percentiles, occupancy, checkpoint freshness.

The port's own copy of ``repro.serve.metrics`` (numpy only): one
``TraceResult`` reduces to one flat ``summarize`` row, the reference's row
format.  Latency definitions:

  * **TTFT**  (time-to-first-token): ``t_first - arrival`` — includes queue
    wait, so it is THE overload signal in an open-loop harness;
  * **TPOT**  (per-token latency): ``(t_done - t_first) / (n_tokens - 1)``
    for requests that generated more than one token;
  * **throughput**: generated tokens / harness wall-clock;
  * **occupancy**: mean occupied slots / slot count, over decode steps;
  * **freshness**: mean/max rounds-behind over decode steps, plus the
    number of mid-stream hot swaps.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.serve.traffic import TraceResult


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def summarize(result: TraceResult, *, slots: int, rate: float,
              extra: Mapping[str, Any] | None = None) -> dict:
    """Flatten one trace into one summary row."""
    done = [r for r in result.completed if r.t_first is not None]
    ttft = [r.t_first - r.arrival for r in done]
    tpot = [
        (r.t_done - r.t_first) / (len(r.tokens) - 1)
        for r in done
        if r.t_done is not None and len(r.tokens) > 1
    ]
    n_tokens = sum(len(r.tokens) for r in done)
    occ = [s.n_active for s in result.steps]
    behind = [s.rounds_behind for s in result.steps]
    # every ratio below must survive degenerate traces: zero completed
    # requests, zero decode steps, zero wall, or a slots=0 probe config
    row = {
        "rate_qps": rate,
        "slots": slots,
        "n_requests": len(result.completed),
        "n_tokens": n_tokens,
        "wall_s": round(result.wall, 4),
        "throughput_tok_s": round(n_tokens / result.wall, 2)
        if result.wall > 0 else 0.0,
        "ttft_p50_ms": round(_pct(ttft, 50) * 1e3, 2),
        "ttft_p95_ms": round(_pct(ttft, 95) * 1e3, 2),
        "ttft_p99_ms": round(_pct(ttft, 99) * 1e3, 2),
        "tpot_p50_ms": round(_pct(tpot, 50) * 1e3, 2),
        "tpot_p95_ms": round(_pct(tpot, 95) * 1e3, 2),
        "tpot_p99_ms": round(_pct(tpot, 99) * 1e3, 2),
        "occupancy": round(float(np.mean(occ)) / slots, 4)
        if occ and slots > 0 else 0.0,
        "decode_steps": result.decode_steps,
        "decode_dispatches": result.decode_dispatches,
        "dispatches_per_step": round(
            result.decode_dispatches / result.decode_steps, 4
        ) if result.decode_steps else 0.0,
        "admit_dispatches": result.admit_dispatches,
        "swaps": result.swaps,
        "staleness_rounds_mean": round(float(np.mean(behind)), 3)
        if behind else 0.0,
        "staleness_rounds_max": int(max(behind)) if behind else 0,
    }
    if extra:
        row.update(extra)
    return row


_MD_COLS = (
    ("rate_qps", "rate (q/s)"),
    ("throughput_tok_s", "tok/s"),
    ("ttft_p50_ms", "TTFT p50 (ms)"),
    ("ttft_p95_ms", "TTFT p95 (ms)"),
    ("ttft_p99_ms", "TTFT p99 (ms)"),
    ("tpot_p50_ms", "TPOT p50 (ms)"),
    ("tpot_p95_ms", "TPOT p95 (ms)"),
    ("tpot_p99_ms", "TPOT p99 (ms)"),
    ("occupancy", "occupancy"),
    ("dispatches_per_step", "disp/step"),
    ("swaps", "swaps"),
    ("staleness_rounds_mean", "stale (mean rounds)"),
    ("staleness_rounds_max", "stale (max)"),
)


def render_markdown(rows: Sequence[Mapping[str, Any]], *, title: str,
                    preamble: str = "") -> str:
    """A markdown table: one row per summary."""
    out = [f"# {title}", ""]
    if preamble:
        out += [preamble, ""]
    out.append("| " + " | ".join(h for _, h in _MD_COLS) + " |")
    out.append("|" + "|".join("---" for _ in _MD_COLS) + "|")
    for row in rows:
        out.append(
            "| " + " | ".join(str(row.get(k, "")) for k, _ in _MD_COLS) + " |"
        )
    out.append("")
    return "\n".join(out)

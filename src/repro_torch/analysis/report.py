"""Report rendering: ``--format md`` (human) and ``--format json`` (CI)."""

from __future__ import annotations

import json
from typing import Any

from repro_torch.analysis.engine import AnalysisResult, Rule


def json_report(
    result: AnalysisResult,
    rules: list[Rule],
    new_fps: set[str],
) -> dict[str, Any]:
    index = result.index
    return {
        "schema": 1,
        "rules": [
            {"id": r.id, "contract": r.contract, "design": r.design}
            for r in rules
        ],
        "files": len(result.contexts),
        "skipped": [{"path": p, "error": e} for p, e in result.skipped],
        "scopes": {
            "hot_path_defs": sorted(index.hot_path_scope()),
            "serve_thread_modules": sorted(index.serve_thread_modules()),
        },
        "findings": [
            {**f.to_dict(), "new": f.fingerprint() in new_fps}
            for f in result.findings
        ],
        "suppressed": [f.to_dict() for f in result.suppressed],
        "counts": {
            "findings": len(result.findings),
            "new": len(new_fps & {f.fingerprint() for f in result.findings}),
            "suppressed": len(result.suppressed),
        },
    }


def render_json(result, rules, new_fps) -> str:
    return json.dumps(json_report(result, rules, new_fps), indent=2,
                      sort_keys=True)


def render_md(result: AnalysisResult, rules: list[Rule],
              new_fps: set[str]) -> str:
    lines = ["# repro_torch.analysis report", ""]
    lines.append(f"{len(result.contexts)} files scanned, "
                 f"{len(result.findings)} findings "
                 f"({len(result.suppressed)} suppressed in-line).")
    lines.append("")
    if result.findings:
        lines += ["| location | rule | finding |", "|---|---|---|"]
        for f in result.findings:
            mark = " **new**" if f.fingerprint() in new_fps else ""
            lines.append(
                f"| `{f.path}:{f.line}` | `{f.rule}`{mark} | {f.message} |"
            )
        lines.append("")
    else:
        lines += ["No findings.", ""]
    if result.suppressed:
        lines.append(f"Suppressed: " + ", ".join(
            f"`{f.path}:{f.line}` [{f.rule}]" for f in result.suppressed))
        lines.append("")
    if result.skipped:
        lines.append("Skipped (unparseable): " + ", ".join(
            p for p, _ in result.skipped))
        lines.append("")
    return "\n".join(lines)


def render_rule_list(rules: list[Rule]) -> str:
    lines = [
        "repro_torch.analysis — contract rules (DESIGN.md §13)",
        "",
    ]
    width = max(len(r.id) for r in rules)
    for r in rules:
        lines.append(f"  {r.id:<{width}}  [{r.design}]  {r.contract}")
    lines.append("")
    lines.append("suppress one site:  # repro: allow[<rule-id>] <reason>")
    return "\n".join(lines)

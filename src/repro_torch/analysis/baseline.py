"""The committed baseline: known findings that do not fail the build.

The baseline is a JSON file of finding fingerprints (line-number-free, so
unrelated edits never churn it).  ``--fail-on-new`` exits nonzero only
for findings whose fingerprint is not baselined — the ratchet: existing
debt is visible but frozen, new debt is blocked.  This repo's committed
baseline is EMPTY (every genuine finding was fixed in the PR that landed
the pass), and the acceptance gate keeps it that way.

The port keeps its own file, ``analysis_baseline_torch.json`` at the repo
root; a missing file is an empty baseline.  The reference's
``analysis_baseline.json`` is never written from here.
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.analysis.findings import Finding

BASELINE_SCHEMA = 1
DEFAULT_BASELINE = "analysis_baseline_torch.json"
REFERENCE_BASELINE = "analysis_baseline.json"


def load_baseline(path: Path) -> set[str]:
    """Fingerprints in the baseline file ({} if absent)."""
    if not path.exists():
        return set()
    payload = json.loads(path.read_text())
    if payload.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"baseline schema {payload.get('schema')!r} != {BASELINE_SCHEMA}"
        )
    return set(payload["fingerprints"])


def write_baseline(path: Path, findings: list[Finding]) -> None:
    if path.name == REFERENCE_BASELINE:
        raise ValueError(
            f"{path}: the reference's baseline is not the port's to write; "
            f"use {DEFAULT_BASELINE}")
    payload = {
        "schema": BASELINE_SCHEMA,
        "fingerprints": sorted(f.fingerprint() for f in findings),
        "sites": [
            {"rule": f.rule, "path": f.path, "snippet": f.snippet,
             "occurrence": f.occurrence}
            for f in sorted(findings, key=lambda x: (x.path, x.line))
        ],
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")


def split_new(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding]]:
    """(new, baselined)."""
    new, old = [], []
    for f in findings:
        (old if f.fingerprint() in baseline else new).append(f)
    return new, old

"""Findings, fingerprints, and `# repro: allow[...]` suppressions.

A ``Finding`` is one rule violation at one source location.  Its
``fingerprint`` deliberately excludes the line number: baselines must
survive unrelated edits above a site, so identity is (rule, file, the
offending source line's text, occurrence index of that text within the
file).  Two textually identical violations in one file get distinct
occurrence indices, so fixing one of them surfaces the other as "new".

Suppressions are per-line comments::

    noised = g + noise  # repro: allow[unaccounted-noise] calibrated in caller

The reason is mandatory — a bare ``allow[rule]`` does not suppress, it
shows up as an ``analysis-suppression`` finding instead, so every escape
hatch in the tree carries its own justification.  A suppression comment on
its own line covers the line below it (for sites too long to share a
line).
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Iterable, Mapping

from repro_torch.canon import content_hash

_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\[(?P<rule>[a-z0-9-]+)\]\s*(?P<reason>.*)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str          # repo-relative, posix separators
    line: int          # 1-indexed
    col: int
    message: str
    snippet: str       # the stripped offending source line
    occurrence: int = 0  # index among identical (rule, snippet) in this file

    def fingerprint(self) -> str:
        return content_hash({
            "rule": self.rule, "path": self.path,
            "snippet": self.snippet, "occurrence": self.occurrence,
        })

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


def assign_occurrences(findings: Iterable[Finding]) -> list[Finding]:
    """Number identical (path, rule, snippet) findings so fingerprints are
    unique; sort by location for stable reports."""
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))
    seen: dict[tuple, int] = {}
    out = []
    for f in ordered:
        key = (f.path, f.rule, f.snippet)
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append(dataclasses.replace(f, occurrence=n))
    return out


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    reason: str
    line: int


def parse_suppressions(source: str) -> dict[int, list[Suppression]]:
    """line -> suppressions covering that line (same line or line above)."""
    by_line: dict[int, list[Suppression]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string, t.start[1])
                    for t in tokens if t.type == tokenize.COMMENT]
    except tokenize.TokenError:
        return by_line
    for lineno, text, col in comments:
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        sup = Suppression(rule=m.group("rule"),
                          reason=m.group("reason").strip(), line=lineno)
        # a comment owning its whole line covers the NEXT line too
        lines = source.splitlines()
        own_line = lines[lineno - 1].lstrip().startswith("#") \
            if lineno <= len(lines) else False
        by_line.setdefault(lineno, []).append(sup)
        if own_line:
            by_line.setdefault(lineno + 1, []).append(sup)
    return by_line


def apply_suppressions(
    findings: list[Finding],
    suppressions_by_path: Mapping[str, Mapping[int, list[Suppression]]],
) -> tuple[list[Finding], list[Finding]]:
    """(kept, suppressed).  A reasonless allow-comment does not suppress —
    it is reported as an ``analysis-suppression`` finding by the engine."""
    kept, suppressed = [], []
    for f in findings:
        sups = suppressions_by_path.get(f.path, {}).get(f.line, [])
        if any(s.rule == f.rule and s.reason for s in sups):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept, suppressed

"""The rule engine: file contexts, the rule registry, and the runner.

Layering (DESIGN.md §13): ``FileContext`` parses one file once — AST,
import-alias table, suppression comments — and every rule shares it.
Rules are registry-discovered citizens exactly like arms and backends
(``@register_rule``): each declares an ``id``, the one-line ``contract``
it enforces, and its DESIGN.md anchor, then implements ``check_file``
(per file) and/or ``check_project`` (cross-file, after the
``ModuleIndex`` is built).

The engine owns the mechanics every rule would otherwise reimplement:
name resolution through import aliases (``ctx.dotted``), finding
construction with repo-relative paths, suppression application, and the
``analysis-suppression`` meta-finding for reasonless allow-comments.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis.findings import (
    Finding,
    Suppression,
    apply_suppressions,
    assign_occurrences,
    parse_suppressions,
)
from repro_torch.analysis.graphs import ModuleIndex


class FileContext:
    """One parsed source file: AST, aliases, suppressions, helpers."""

    def __init__(self, path: Path, rel: str, module: str, source: str) -> None:
        self.path = path
        self.rel = rel                      # repo-relative posix path
        self.module = module                # dotted module name
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=rel)
        self.suppressions: dict[int, list[Suppression]] = \
            parse_suppressions(source)
        self.aliases = _collect_aliases(self.tree)

    # -- name resolution ------------------------------------------------------

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve a Name/Attribute chain through the import-alias table.

        ``np.asarray`` -> "numpy.asarray" under ``import numpy as np``;
        ``fused.stack_poisson`` -> "repro_torch.arms.fused.stack_poisson"
        under ``from repro_torch.arms import fused``.  Unresolvable chains (calls on
        arbitrary objects) return the bare trailing chain or None.
        """
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id, node.id)
        return ".".join([base] + list(reversed(parts)))

    # -- finding construction -------------------------------------------------

    def finding(self, rule: "Rule | str", node: ast.AST, message: str) -> Finding:
        rule_id = rule if isinstance(rule, str) else rule.id
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = self.lines[line - 1].strip() if line <= len(self.lines) else ""
        return Finding(rule=rule_id, path=self.rel, line=line, col=col,
                       message=message, snippet=snippet)


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    """name -> dotted target, from every import statement in the file
    (function-level imports included: resolution is name-scoped enough)."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
                if a.asname is None and "." in a.name:
                    # "import jax.random" binds "jax" but makes the full
                    # dotted path resolvable; keep the root binding
                    aliases[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


# -- rule registry ------------------------------------------------------------


class Rule:
    """Base class: one machine-checked repo contract."""

    id: str = ""
    contract: str = ""          # one line: the invariant enforced
    design: str = "§13"         # DESIGN.md anchor

    def check_file(self, ctx: FileContext, index: ModuleIndex) -> Iterator[Finding]:
        return iter(())

    def check_project(
        self, contexts: list[FileContext], index: ModuleIndex
    ) -> Iterator[Finding]:
        return iter(())


_RULES: dict[str, type[Rule]] = {}


def register_rule(cls: type[Rule]) -> type[Rule]:
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _RULES:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _RULES[cls.id] = cls
    return cls


def all_rules() -> list[Rule]:
    import repro_torch.analysis.rules  # noqa: F401  (registration side effect)
    return [_RULES[k]() for k in sorted(_RULES)]


# -- runner -------------------------------------------------------------------


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]       # post-suppression
    suppressed: list[Finding]
    contexts: list[FileContext]
    index: ModuleIndex
    skipped: list[tuple[str, str]]  # (path, reason) — unparseable files


def module_name_for(rel: str) -> str:
    """Dotted module name from a repo-relative path.

    Files under ``src/`` get their import name (``repro_torch.arms.fused``);
    everything else is dotted from the repo root (``tests.test_obs``).
    """
    p = Path(rel)
    parts = list(p.parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = p.stem
    return ".".join(parts)


def collect_files(paths: Iterable[Path], root: Path) -> list[tuple[Path, str]]:
    """(path, repo-relative posix) for every .py under ``paths``, sorted."""
    out = []
    for p in paths:
        p = Path(p)
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            if "__pycache__" in f.parts or f.suffix != ".py":
                continue
            try:
                rel = f.resolve().relative_to(root.resolve()).as_posix()
            except ValueError:
                rel = f.as_posix()
            out.append((f, rel))
    return sorted(set(out), key=lambda t: t[1])


def run_analysis(
    paths: Iterable[Path],
    root: Path,
    rules: Iterable[Rule] | None = None,
    only_paths: set[str] | None = None,
) -> AnalysisResult:
    """Parse, index, run every rule, apply suppressions.

    ``only_paths`` (repo-relative) restricts *emission* to those files —
    the index (and therefore the computed scopes) is always built from the
    full file set, so ``--changed`` runs see the same scopes as full runs.
    """
    rules = list(rules) if rules is not None else all_rules()
    contexts: list[FileContext] = []
    skipped: list[tuple[str, str]] = []
    for path, rel in collect_files(paths, root):
        try:
            source = path.read_text()
            contexts.append(FileContext(path, rel, module_name_for(rel), source))
        except (OSError, SyntaxError, ValueError) as e:
            skipped.append((rel, str(e)))
    index = ModuleIndex.build(contexts)

    raw: list[Finding] = []
    for rule in rules:
        for ctx in contexts:
            raw.extend(rule.check_file(ctx, index))
        raw.extend(rule.check_project(contexts, index))

    # reasonless allow-comments are findings themselves (dedup: an own-line
    # comment registers under two line keys but is one suppression)
    for ctx in contexts:
        seen: set[tuple[str, int]] = set()
        for sups in ctx.suppressions.values():
            for s in sups:
                if s.reason or (s.rule, s.line) in seen:
                    continue
                seen.add((s.rule, s.line))
                raw.append(Finding(
                    rule="analysis-suppression", path=ctx.rel,
                    line=s.line, col=0,
                    message=f"allow[{s.rule}] without a reason — "
                            "suppressions must say why",
                    snippet=ctx.lines[s.line - 1].strip()
                    if s.line <= len(ctx.lines) else "",
                ))

    if only_paths is not None:
        raw = [f for f in raw if f.path in only_paths]
    raw = assign_occurrences(raw)
    sup_map = {ctx.rel: ctx.suppressions for ctx in contexts}
    kept, suppressed = apply_suppressions(raw, sup_map)
    return AnalysisResult(findings=kept, suppressed=suppressed,
                          contexts=contexts, index=index, skipped=skipped)

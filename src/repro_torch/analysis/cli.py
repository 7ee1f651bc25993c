"""``python -m repro_torch.analysis`` — run the contract rules over the port.

Exit status: 0 when no findings fail the gate, 1 otherwise, 2 on usage
errors.  Without ``--fail-on-new`` every finding fails; with it, only
findings absent from the baseline do (the CI ratchet).  ``--changed``
restricts *reporting* to files touched vs a git ref — the module index
(and therefore the computed hot-path / serve-thread scopes) is still
built from the full path set, so scoped runs agree with full runs.

The reference's flags, with the port's defaults: the paths
``src/repro_torch`` and ``tests/test_torch_*.py`` (a path may be a glob,
expanded under the root), and the baseline ``analysis_baseline_torch.json``.
"""

from __future__ import annotations

import argparse
import glob
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    load_baseline,
    split_new,
    write_baseline,
)
from repro_torch.analysis.engine import all_rules, run_analysis
from repro_torch.analysis.report import (
    render_json,
    render_md,
    render_rule_list,
)


def _repo_root(start: Path) -> Path:
    for cand in [start, *start.parents]:
        if (cand / ".git").exists():
            return cand
    return start


def _changed_files(root: Path, ref: str) -> set[str]:
    """Repo-relative paths changed vs ``ref`` (plus untracked)."""
    out = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=root, capture_output=True, text=True, check=True,
    ).stdout
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=root, capture_output=True, text=True, check=True,
    ).stdout
    return {ln.strip() for ln in (out + untracked).splitlines() if ln.strip()}


DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py")
_GLOB_CHARS = frozenset("*?[")


def _expand(root: Path, arg: str) -> list[Path]:
    """One CLI path: itself, or its glob's matches under ``root`` (sorted;
    a glob that matches nothing comes back as itself, so it is reported
    missing)."""
    p = Path(arg) if Path(arg).is_absolute() else root / arg
    if not _GLOB_CHARS & set(arg):
        return [p]
    return [Path(h) for h in sorted(glob.glob(str(p)))] or [p]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract-aware static analysis for the port",
    )
    p.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                   help="files/directories/globs to scan (default: "
                        + " ".join(DEFAULT_PATHS) + ")")
    p.add_argument("--format", choices=("json", "md"), default="md")
    p.add_argument("--out", type=Path, default=None,
                   help="write the report here instead of stdout")
    p.add_argument("--baseline", type=Path, default=None,
                   help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    p.add_argument("--write-baseline", action="store_true",
                   help="write current findings to the baseline and exit 0")
    p.add_argument("--fail-on-new", action="store_true",
                   help="fail only on findings not in the baseline")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="REF",
                   help="report only files changed vs REF (default HEAD); "
                        "scopes still come from the full path set")
    p.add_argument("--list-rules", action="store_true",
                   help="print every rule id, contract, and DESIGN anchor")
    p.add_argument("--root", type=Path, default=None,
                   help="repo root override (default: nearest .git upward)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()

    if args.list_rules:
        print(render_rule_list(rules))
        return 0

    root = (args.root or _repo_root(Path.cwd())).resolve()
    paths = [p for arg in (args.paths or DEFAULT_PATHS)
             for p in _expand(root, arg)]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path: {', '.join(map(str, missing))}",
              file=sys.stderr)
        return 2

    only_paths: set[str] | None = None
    if args.changed is not None:
        try:
            only_paths = {p for p in _changed_files(root, args.changed)
                          if p.endswith(".py")}
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"error: --changed needs a git checkout ({e})",
                  file=sys.stderr)
            return 2

    result = run_analysis(paths, root, rules=rules, only_paths=only_paths)

    baseline_path = args.baseline or (root / DEFAULT_BASELINE)
    if args.write_baseline:
        try:
            write_baseline(baseline_path, result.findings)
        except ValueError as e:          # the reference's baseline file
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"wrote {len(result.findings)} fingerprints to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, _old = split_new(result.findings, baseline)
    new_fps = {f.fingerprint() for f in new}

    report = (render_json if args.format == "json" else render_md)(
        result, rules, new_fps)
    if args.out:
        args.out.write_text(report + "\n")
    else:
        print(report)

    failing = new if args.fail_on_new else result.findings
    if failing:
        for f in failing:
            print(f.render(), file=sys.stderr)
        label = "new " if args.fail_on_new else ""
        print(f"FAILED: {len(failing)} {label}finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""repro_torch.analysis — contract-aware static analysis for the port.

The port's copy of ``repro.analysis``: a stdlib-``ast`` rule engine
(DESIGN.md §13) that machine-checks the invariants the port is built on,
with rules that know PyTorch's idioms: explicit generators for every draw
(``prng-key-discipline``), one host sync per fused round
(``host-sync-hygiene``), noise accounting (``unaccounted-noise``), lock
coverage of thread-shared state, canonical hashing, and (spec, seed)
determinism.  Scopes like "the fused hot path" and "serve-thread-reachable
modules" are computed from a module-import + call graph, never
hand-listed.  Suppressions use the reference's spelling,
``# repro: allow[<rule-id>] <reason>``, so one comment serves both gates.

Run it: ``python -m repro_torch.analysis`` (default paths
``src/repro_torch`` and ``tests/test_torch_*.py``, default baseline
``analysis_baseline_torch.json``).
"""

from repro_torch.analysis.engine import (
    AnalysisResult,
    FileContext,
    Rule,
    all_rules,
    register_rule,
    run_analysis,
)
from repro_torch.analysis.findings import Finding, Suppression

__all__ = [
    "AnalysisResult",
    "FileContext",
    "Finding",
    "Rule",
    "Suppression",
    "all_rules",
    "register_rule",
    "run_analysis",
]

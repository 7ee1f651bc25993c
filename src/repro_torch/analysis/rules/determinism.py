"""nondeterminism: content-addressed modules must be pure in (spec, seed).

The §10 determinism contract — same spec + seed ⇒ byte-identical compute
graph — and the §11 ledger chain are stated over *content*: a wall-clock
read, an unseeded global-``random`` draw, or a ``hash()`` (salted per
process by PYTHONHASHSEED) anywhere in the trace/solve/graph/ledger
modules breaks the address space silently — the re-trace gate in CI would
catch it a build later, with no pointer to the line that did it.

Scope: the ``repro_torch.population`` package and
``repro_torch.obs.ledger``.  CLI modules (``*.cli``) are reporting layers —
they time and print but never feed content hashes — and are excluded.  Host wall timing inside
``solve`` is legitimate *measurement* (reported beside, never inside, the
content-addressed records) and carries per-site ``allow[...]``
suppressions saying exactly that.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import FileContext, Rule, register_rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graphs import ModuleIndex

SCOPED_PREFIXES = ("repro_torch.population",)
SCOPED_MODULES = ("repro_torch.obs.ledger",)

_BANNED = {
    "time.time": "wall clock",
    "time.time_ns": "wall clock",
    "time.monotonic": "process-relative clock",
    "time.perf_counter": "process-relative clock",
    "datetime.datetime.now": "wall clock",
    "datetime.datetime.utcnow": "wall clock",
    "datetime.datetime.today": "wall clock",
    "datetime.date.today": "wall clock",
    "os.urandom": "entropy source",
    "uuid.uuid4": "entropy source",
    "uuid.uuid1": "host/time-derived id",
    "secrets.token_bytes": "entropy source",
    "secrets.token_hex": "entropy source",
}

# global-``random`` module draws (unseeded process-wide stream); seeded
# ``random.Random(...)`` instances are the sanctioned spelling
_GLOBAL_RANDOM = frozenset(
    f"random.{n}" for n in (
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "expovariate", "betavariate",
        "lognormvariate", "normalvariate", "vonmisesvariate", "paretovariate",
        "weibullvariate", "triangular", "getrandbits", "randbytes",
    )
)


@register_rule
class Nondeterminism(Rule):
    id = "nondeterminism"
    contract = ("trace/solve/graph/ledger modules are pure in (spec, seed): "
                "no wall clock, no unseeded random, no process-salted hash()")
    design = "§13.6"

    def _in_scope(self, module: str) -> bool:
        if module.split(".")[-1] == "cli" or module.endswith("__main__"):
            return False
        return module in SCOPED_MODULES or module.startswith(SCOPED_PREFIXES)

    def check_file(self, ctx: FileContext, index: ModuleIndex) -> Iterator[Finding]:
        if not self._in_scope(ctx.module):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted(node.func)
            if dotted in _BANNED:
                yield ctx.finding(
                    self, node,
                    f"{dotted} ({_BANNED[dotted]}) in content-addressed "
                    f"module {ctx.module} — breaks same-(spec,seed) ⇒ "
                    "same-bytes",
                )
            elif dotted in _GLOBAL_RANDOM:
                yield ctx.finding(
                    self, node,
                    f"global {dotted} (process-wide unseeded stream) in "
                    f"{ctx.module} — use a tagged random.Random instance",
                )
            elif isinstance(node.func, ast.Name) and node.func.id == "hash" \
                    and len(node.args) == 1:
                yield ctx.finding(
                    self, node,
                    "builtin hash() is salted per process (PYTHONHASHSEED) — "
                    "use repro_torch.canon.content_hash for stable addresses",
                )

"""locked-shared-state: the serve trainer-thread race class, as a rule.

``python -m repro_torch.serve --train-rounds N`` runs a federation trainer
thread concurrently with the decode loop; both traverse shared modules
(the reference's dispatch counter lost ticks exactly this way before it
was locked; ``repro_torch.instrument``'s is locked).  The rule audits
every module in the import-closure of a ``threading.Thread(target=…)``
function — a scope computed from the scanned tree, so a new thread widens
it automatically — for module-level mutable state mutated inside a
function without an enclosing ``with <lock>:``.

What counts as module state: module-level names bound to dict/list/set
literals (or dict()/list()/set()/defaultdict/deque constructors), or
rebound via ``global`` inside a function (the ``_STATE = None`` +
``global`` pattern).  Import-time registration is exempt by convention:
mutations inside functions named ``register*`` run under the import lock
before any thread exists.  ``threading.local()`` values are inherently
per-thread and never flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import FileContext, Rule, register_rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graphs import ModuleIndex

_MUTATORS = frozenset({
    "append", "add", "update", "pop", "setdefault", "extend", "insert",
    "remove", "clear", "popitem", "discard", "appendleft",
})

_MUTABLE_CTORS = frozenset({
    "dict", "list", "set", "collections.defaultdict", "collections.deque",
    "collections.OrderedDict", "collections.Counter",
})


def _module_state_names(ctx: FileContext) -> set[str]:
    """Module-level names holding (potentially) shared mutable state."""
    mutable: set[str] = set()
    for node in ctx.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and node.value is not None:
            targets = [node.target]
        if not targets:
            continue
        value = node.value
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                              ast.ListComp, ast.SetComp)) or (
                isinstance(value, ast.Call)
                and (ctx.dotted(value.func) or "") in _MUTABLE_CTORS):
            mutable.update(t.id for t in targets)
    # the `_STATE = None` + `global _STATE` rebind pattern
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Global):
            mutable.update(node.names)
    return {n for n in mutable if not (n.startswith("__") and n.endswith("__"))}


@register_rule
class LockedSharedState(Rule):
    id = "locked-shared-state"
    contract = ("module-level mutable state in serve-thread-reachable "
                "modules is only mutated under a lock")
    design = "§13.4"

    def check_file(self, ctx: FileContext, index: ModuleIndex) -> Iterator[Finding]:
        if ctx.module not in index.serve_thread_modules():
            return
        state = _module_state_names(ctx)
        if not state:
            return

        findings: list[Finding] = []

        def visit(node: ast.AST, fn: ast.AST | None, lock_depth: int,
                  globals_in_fn: frozenset[str]) -> None:
            for child in ast.iter_child_nodes(node):
                child_fn, child_lock, child_globals = fn, lock_depth, globals_in_fn
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if child.name.startswith("register"):
                        continue  # import-time registration convention
                    child_fn = child
                    child_globals = frozenset(
                        n for g in ast.walk(child)
                        if isinstance(g, ast.Global) for n in g.names
                    )
                elif isinstance(child, ast.With):
                    if any("lock" in ast.unparse(i.context_expr).lower()
                           for i in child.items):
                        child_lock = lock_depth + 1
                if fn is not None and lock_depth == 0:
                    hit = self._mutation(child, state, globals_in_fn)
                    if hit:
                        fn_name = getattr(fn, "name", "<fn>")
                        findings.append(ctx.finding(
                            self, child,
                            f"module state {hit!r} mutated in {fn_name}() "
                            "without a lock — racy when the serve trainer "
                            "thread runs concurrently (use a lock or "
                            "threading.local)",
                        ))
                visit(child, child_fn, child_lock, child_globals)

        visit(ctx.tree, None, 0, frozenset())
        yield from findings

    @staticmethod
    def _mutation(node: ast.AST, state: set[str],
                  globals_in_fn: frozenset[str]) -> str | None:
        """The state name this statement mutates, if any."""
        def target_hit(t: ast.AST, allow_bare: bool) -> str | None:
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and t.value.id in state:
                return t.value.id
            if allow_bare and isinstance(t, ast.Name) and t.id in state \
                    and t.id in globals_in_fn:
                return t.id
            return None

        if isinstance(node, ast.Assign):
            for t in node.targets:
                hit = target_hit(t, allow_bare=True)
                if hit:
                    return hit
        elif isinstance(node, ast.AugAssign):
            return target_hit(node.target, allow_bare=True)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                hit = target_hit(t, allow_bare=False)
                if hit:
                    return hit
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in _MUTATORS and \
                    isinstance(call.func.value, ast.Name) and \
                    call.func.value.id in state:
                return call.func.value.id
        return None

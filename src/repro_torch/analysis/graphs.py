"""Module-import and call graphs: computed scopes for contract rules.

Two scopes in this repo are *sets of code*, not sets of names, and grow
every time an arm or a thread lands — so they are computed from the
source instead of hand-listed (the whole point of DESIGN.md §13):

  * **fused hot path** — every function reachable, through the lightweight
    call graph, from any ``fused_round`` definition (the §7 one-dispatch /
    one-sync cohort round step).  ``host-sync-hygiene`` flags device syncs
    inside this scope.
  * **serve-thread-reachable modules** — the module-import closure of
    every module whose function is passed as ``threading.Thread(target=…)``
    anywhere in the scanned tree (the serve trainer-thread race class).
    ``locked-shared-state`` audits module-level mutable state there.

The call graph is deliberately lightweight and *over-approximate*: calls
are resolved through each module's import-alias table when possible;
bare-attribute calls (``self.foo()``, ``obj.foo()``) fall back to every
known def named ``foo`` whose module is the caller's module or in its
import closure.  Over-approximation only widens a scope — a too-wide
scope can surface a spurious finding (suppressible, visibly), a too-narrow
one silently waives the contract, so widening is the safe direction.
Closures stashed on ``self`` (e.g. the cohort programs built in arm
``__init__``) are invisible to it; those bodies run inside the round's one
``instrumented`` program call.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.analysis.engine import FileContext


@dataclasses.dataclass
class DefInfo:
    """One function/method definition."""

    full_id: str             # "repro_torch.arms.decaph:DeCaPHArm.fused_round"
    module: str
    qual: str                # "DeCaPHArm.fused_round"
    name: str                # "fused_round"
    path: str
    lineno: int
    node: ast.AST


class ModuleIndex:
    """Cross-file index: defs, import graph, call graph, computed scopes."""

    def __init__(self) -> None:
        self.defs: dict[str, DefInfo] = {}
        self.by_name: dict[str, list[str]] = {}       # bare name -> full_ids
        self.module_imports: dict[str, set[str]] = {}  # module -> modules
        self.calls: dict[str, set[tuple[str, str]]] = {}
        # full_id -> {("dotted", "a.b.c") | ("bare", "foo")}
        self.thread_targets: list[str] = []            # resolved root full_ids
        self.modules: set[str] = set()
        self._raw_thread_targets: list[tuple[str, str, str]] = []

    # -- construction --------------------------------------------------------

    def add_file(self, ctx: "FileContext") -> None:
        self.modules.add(ctx.module)
        imports = self.module_imports.setdefault(ctx.module, set())
        for alias_target in ctx.aliases.values():
            imports.add(alias_target)
        _DefCollector(self, ctx).visit(ctx.tree)

    def finish(self) -> None:
        """Resolve thread targets after every file is indexed."""
        resolved = []
        for ref in self._raw_thread_targets:
            resolved.extend(self._resolve(ref[0], ref[1], ref[2]))
        self.thread_targets = resolved

    @classmethod
    def build(cls, contexts: Iterable["FileContext"]) -> "ModuleIndex":
        index = cls()
        for ctx in contexts:
            index.add_file(ctx)
        index.finish()
        return index

    # -- resolution ----------------------------------------------------------

    def _import_closure(self, module: str) -> set[str]:
        seen, frontier = {module}, [module]
        while frontier:
            m = frontier.pop()
            for dep in self.module_imports.get(m, ()):
                # imports may name objects ("pkg.mod.func"): walk prefixes
                # until one is a known module
                candidate = dep
                while candidate and candidate not in self.modules:
                    candidate = candidate.rpartition(".")[0]
                if candidate and candidate not in seen:
                    seen.add(candidate)
                    frontier.append(candidate)
        return seen

    def _resolve(self, kind: str, ref: str, caller_module: str) -> list[str]:
        """Resolve one call edge to zero or more known defs."""
        if kind == "dotted":
            mod, _, name = ref.rpartition(".")
            hit = self.defs.get(f"{mod}:{name}")
            if hit:
                return [hit.full_id]
            # "module:Class.method" via "pkg.mod.Class.method"
            mod2, _, cls = mod.rpartition(".")
            hit = self.defs.get(f"{mod2}:{cls}.{name}")
            return [hit.full_id] if hit else []
        # bare attribute call: every same-named def visible from the caller
        closure = self._import_closure(caller_module)
        return [fid for fid in self.by_name.get(ref, ())
                if self.defs[fid].module in closure]

    # -- reachability --------------------------------------------------------

    def reachable_from(self, roots: Iterable[str]) -> set[str]:
        seen = set(roots)
        frontier = list(seen)
        while frontier:
            fid = frontier.pop()
            caller_module = self.defs[fid].module if fid in self.defs else ""
            for kind, ref in self.calls.get(fid, ()):
                for callee in self._resolve(kind, ref, caller_module):
                    if callee not in seen:
                        seen.add(callee)
                        frontier.append(callee)
        return seen

    # -- the two computed scopes ---------------------------------------------

    def hot_path_scope(self) -> set[str]:
        """full_ids reachable from any ``fused_round`` definition."""
        roots = [fid for fid, d in self.defs.items() if d.name == "fused_round"]
        return self.reachable_from(roots)

    def serve_thread_modules(self) -> set[str]:
        """Import closure of every module owning a Thread-target function."""
        out: set[str] = set()
        for fid in self.thread_targets:
            if fid in self.defs:
                out |= self._import_closure(self.defs[fid].module)
        return out


class _DefCollector(ast.NodeVisitor):
    """Collect defs, call edges, and Thread(target=...) sites for one file."""

    def __init__(self, index: ModuleIndex, ctx: "FileContext") -> None:
        self.index = index
        self.ctx = ctx
        self.stack: list[str] = []   # class/function qualname parts
        self.current_fn: list[str] = []  # full_id stack

    # defs ---------------------------------------------------------------

    def _visit_def(self, node) -> None:
        qual = ".".join(self.stack + [node.name])
        full_id = f"{self.ctx.module}:{qual}"
        info = DefInfo(full_id=full_id, module=self.ctx.module, qual=qual,
                       name=node.name, path=self.ctx.rel, lineno=node.lineno,
                       node=node)
        self.index.defs[full_id] = info
        self.index.by_name.setdefault(node.name, []).append(full_id)
        self.stack.append(node.name)
        self.current_fn.append(full_id)
        self.generic_visit(node)
        self.current_fn.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    # call edges + thread targets ---------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = self.ctx.dotted(node.func)
        if dotted in ("threading.Thread", "Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    ref = self.ctx.dotted(kw.value)
                    if ref:
                        kind = "dotted" if "." in ref else "bare"
                        self.index._raw_thread_targets.append(
                            (kind, ref, self.ctx.module)
                        )
        if self.current_fn:
            caller = self.current_fn[-1]
            edges = self.index.calls.setdefault(caller, set())
            if dotted and "." in dotted:
                edges.add(("dotted", dotted))
            elif dotted:
                # bare local call: same-module def or visible same-named def
                edges.add(("dotted", f"{self.ctx.module}.{dotted}"))
                edges.add(("bare", dotted))
            elif isinstance(node.func, ast.Attribute):
                edges.add(("bare", node.func.attr))
        self.generic_visit(node)

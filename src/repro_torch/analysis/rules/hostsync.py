"""host-sync-hygiene: the §7 one-sync-per-round contract, machine-checked.

The port's fused cohort round is ONE program call plus ONE host sync per
round (DESIGN.md §7; the call half is counted by
``repro_torch.instrument``).  Any ``.item()``, ``.cpu()``, ``.numpy()``,
``.tolist()``, ``.to("cpu")``, ``torch.cuda.synchronize()`` or
``float``/``int``/``bool`` of a tensor that creeps into code reachable
from a ``fused_round`` blocks the host on the device once per call site.

Scope is *computed*: every def reachable through the call graph from any
``fused_round`` definition (``ModuleIndex.hot_path_scope``), minus the
sanctioned sync point — ``repro_torch.arms.fused:build_contributions`` is
THE one host sync the contract allows (its helpers are reachable through
it and stay in scope, so a sync there carries its own ``allow``).

Heuristics, chosen so host-side cohort bookkeeping stays quiet.  A call
is not a sync when its receiver (or argument, for ``float``/``int``/
``bool``) is *host data*:

  * built by numpy (``np.asarray(sizes, np.float32).tolist()``), or a
    constant, ``len(...)``, ``int(...)`` or ``round(...)``;
  * a name bound, in the same function, from host data (an assignment,
    or a ``for``/comprehension target over host data);
  * a field of a value returned by a def of the scanned tree whose return
    annotation is a class that annotates that field as numpy, ``list``,
    ``int``, ``float`` or ``bool`` (``cb.counts.tolist()`` where
    ``cb = fused.stack_poisson(...)`` returns a ``CohortBatch`` whose
    ``counts: np.ndarray``).

A chain reports once: ``x.cpu().numpy()`` is one finding, on ``.cpu()``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import FileContext, Rule, register_rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graphs import ModuleIndex

# the sanctioned sync point (§7): one host transfer per round, here only
WHITELIST = frozenset({
    "repro_torch.arms.fused:build_contributions",
})

_SYNC_DOTTED = frozenset({"torch.cuda.synchronize"})
_SYNC_METHODS = frozenset({"item", "cpu", "numpy", "tolist", "synchronize"})
_SCALAR_CASTS = frozenset({"float", "int", "bool"})
_HOST_ANNOTATIONS = ("ndarray", "list", "int", "float", "bool", "str")


def _host_field_table(contexts) -> dict[str, set[str]]:
    """class name -> fields annotated as host data, over every file."""
    table: dict[str, set[str]] = {}
    for ctx in contexts:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    ann = ast.unparse(stmt.annotation)
                    if ann.split("[")[0].split(".")[-1] in _HOST_ANNOTATIONS:
                        table.setdefault(node.name, set()).add(stmt.target.id)
    return table


def _is_cpu(ctx: FileContext, node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and \
            ctx.dotted(node.func) == "torch.device" and node.args:
        return _is_cpu(ctx, node.args[0])
    return False


class _HostData:
    """Which expressions of one def are host data (see module docstring)."""

    def __init__(self, ctx: FileContext, index: ModuleIndex, caller: str,
                 fn: ast.AST, fields: dict[str, set[str]]) -> None:
        self.ctx, self.fields = ctx, fields
        self.names: set[str] = set()
        self.typed: dict[str, str] = {}   # name -> returned class
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.comprehension)) and \
                    self.host(node.iter):
                self.names |= {n.id for n in ast.walk(node.target)
                               if isinstance(n, ast.Name)}
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if self.host(node.value):
                self.names.add(name)
            elif isinstance(node.value, ast.Call):
                cls = self._returned_class(index, caller, node.value)
                if cls in fields:
                    self.typed[name] = cls

    def _returned_class(self, index: ModuleIndex, caller: str,
                        call: ast.Call) -> str | None:
        dotted = self.ctx.dotted(call.func)
        if dotted and "." not in dotted:
            dotted = f"{self.ctx.module}.{dotted}"
        if not dotted:
            return None
        module = index.defs[caller].module if caller in index.defs else ""
        for fid in index._resolve("dotted", dotted, module):
            returns = getattr(index.defs[fid].node, "returns", None)
            if returns is not None:
                return ast.unparse(returns).strip("'\"").split(".")[-1]
        return None

    def host(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.host(node.value)
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id in self.typed:
                return node.attr in self.fields[self.typed[base.id]]
            return self.host(base)
        if isinstance(node, ast.Call):
            dotted = self.ctx.dotted(node.func) or ""
            if dotted.startswith("numpy.") or dotted in ("len", "int",
                                                         "round"):
                return True
            if isinstance(node.func, ast.Attribute):
                return self.host(node.func.value)
        return False


@register_rule
class HostSyncHygiene(Rule):
    id = "host-sync-hygiene"
    contract = ("no device->host sync inside code reachable from a "
                "fused_round, except the sanctioned sync points")
    design = "§13.2"

    def check_project(self, contexts, index: ModuleIndex) -> Iterator[Finding]:
        scope = index.hot_path_scope() - WHITELIST
        fields = _host_field_table(contexts)
        by_path = {ctx.rel: ctx for ctx in contexts}
        for fid in sorted(scope):
            info = index.defs.get(fid)
            if info is None or info.path not in by_path:
                continue
            ctx = by_path[info.path]
            host = _HostData(ctx, index, fid, info.node, fields)
            # nested defs run inside the same dispatch region: the walk
            # deliberately includes closures defined inline
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call):
                    what = self._sync(ctx, host, node)
                    if what:
                        yield ctx.finding(
                            self, node,
                            f"{what} inside the fused hot path ({fid}) — "
                            "device sync outside the sanctioned sync point",
                        )

    def _sync(self, ctx: FileContext, host: _HostData,
              node: ast.Call) -> str | None:
        """What makes ``node`` a device->host sync, or None."""
        dotted = ctx.dotted(node.func)
        if dotted in _SYNC_DOTTED:
            return dotted
        func = node.func
        if isinstance(func, ast.Attribute):
            recv = func.value
            if host.host(recv) or (isinstance(recv, ast.Call)
                                   and self._sync(ctx, host, recv)):
                return None          # host data, or the chain's first sync
            if func.attr in _SYNC_METHODS and not node.args:
                return f".{func.attr}()"
            if func.attr == "to" and (
                    any(_is_cpu(ctx, a) for a in node.args)
                    or any(kw.arg == "device" and _is_cpu(ctx, kw.value)
                           for kw in node.keywords)):
                return '.to("cpu")'
            return None
        if isinstance(func, ast.Name) and func.id in _SCALAR_CASTS \
                and node.args and not host.host(node.args[0]):
            return f"{func.id}(...) of a possible tensor"
        return None

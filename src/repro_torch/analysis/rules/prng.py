"""prng-key-discipline: every draw names its stream, and no stream is
consumed twice.

The port's counterpart of the reference's rule.  JAX threads an explicit
key through every draw; PyTorch draws from a process-wide default
generator unless a ``torch.Generator`` is passed.  A draw on the global
stream makes a run's noise depend on whatever else drew before it, and two
generators seeded alike add *correlated* noise: either way the ledger's ε
is a fiction.  Four checks:

  1. **Global-stream draws** (src/ only) — ``torch.randn``, ``rand``,
     ``randint``, ``normal``, ``randperm``, ``bernoulli``, ``multinomial``
     (and the ``torch.nn.init`` draws), or the in-place methods
     ``Tensor.normal_``, ``uniform_``, ``bernoulli_``, ``exponential_``,
     ``random_``, ``cauchy_``, ``log_normal_`` and ``geometric_``, called
     without ``generator=``.  Tests draw fixtures freely and are exempt.
  2. **Seed reuse** — the counterpart of key reuse: two generators seeded
     (``gen.manual_seed(E)``, ``torch.manual_seed(E)``) from the same
     expression ``E`` in one function with none of ``E``'s names rebound
     between them, or a seeding inside a loop whose expression no name of
     the loop rebinds (every pass restarts the same stream).  Comprehension
     targets are fresh per iteration.
  3. **Stream-constant collisions** (src/ only) — module-level
     ``*_STREAM`` / ``*_SALT`` integers are the per-purpose noise-stream
     namespaces (decaph 17, primia 31, gossip-dp 53,
     ``core.dp.TOPUP_STREAM`` 1_000_003); two modules defining the same
     value collapse two namespaces onto one stream.
  4. **Untagged stdlib seeds** (src/ only) — ``random.Random(seed)`` must
     use the ``f"{seed}:{tag}"`` tagged-stream discipline of
     ``repro_torch.population.spec``, unchanged from the reference.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import FileContext, Rule, register_rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graphs import ModuleIndex

DRAW_FNS = frozenset(
    [f"torch.{n}" for n in (
        "randn", "rand", "randint", "normal", "randperm", "bernoulli",
        "multinomial", "poisson")]
    + [f"torch.nn.init.{n}" for n in (
        "normal_", "uniform_", "trunc_normal_", "kaiming_normal_",
        "kaiming_uniform_", "xavier_normal_", "xavier_uniform_",
        "orthogonal_")]
)
DRAW_METHODS = frozenset({
    "normal_", "uniform_", "bernoulli_", "exponential_", "random_",
    "cauchy_", "log_normal_", "geometric_",
})
SEED_FNS = frozenset({"torch.manual_seed", "torch.cuda.manual_seed",
                      "torch.cuda.manual_seed_all"})
STREAM_SUFFIXES = ("_STREAM", "_SALT")


def _assigned_names(node: ast.AST) -> set[str]:
    """Every name (re)bound anywhere under ``node``."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
        elif isinstance(n, ast.NamedExpr) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def _loaded_names(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register_rule
class PrngKeyDiscipline(Rule):
    id = "prng-key-discipline"
    contract = ("every draw names its torch.Generator; no two generators "
                "share a seed; stream namespaces unique; stdlib seeds "
                "tagged f\"{seed}:{tag}\"")
    design = "§13.1"

    def check_file(self, ctx: FileContext, index: ModuleIndex) -> Iterator[Finding]:
        yield from self._seed_reuse(ctx)
        if ctx.rel.startswith("src/"):
            yield from self._global_stream(ctx)
            yield from self._untagged_random(ctx)

    # -- 1: draws on the global stream ----------------------------------------

    def _global_stream(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or _has_generator(node):
                continue
            dotted = ctx.dotted(node.func)
            if dotted in DRAW_FNS:
                what = dotted
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in DRAW_METHODS and dotted not in DRAW_FNS:
                what = f".{node.func.attr}()"
            else:
                continue
            yield ctx.finding(
                self, node,
                f"{what} without generator= draws from the process-wide "
                "default stream — pass the run's torch.Generator",
            )

    # -- 2: seed reuse --------------------------------------------------------

    @staticmethod
    def _seed_expr(ctx: FileContext, node: ast.Call) -> ast.AST | None:
        """The seed expression of a seeding call, or None."""
        if not node.args:
            return None
        dotted = ctx.dotted(node.func)
        if dotted in SEED_FNS or (isinstance(node.func, ast.Attribute)
                                  and node.func.attr == "manual_seed"):
            return node.args[0]
        return None

    def _seed_reuse(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            seeds = []        # (lineno, expr text, names, node)
            rebinds = []      # (lineno, name)
            comp_targets: set[str] = set()
            loops = []
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    expr = self._seed_expr(ctx, node)
                    if expr is not None:
                        seeds.append((node.lineno, ast.unparse(expr),
                                      _loaded_names(expr), node))
                elif isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Store):
                    rebinds.append((node.lineno, node.id))
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    for gen in node.generators:
                        comp_targets |= _assigned_names(gen.target)
                elif isinstance(node, (ast.For, ast.While)):
                    loops.append(node)

            # (a) sequential reuse: one seed expression twice, no rebind of
            # any of its names between the two
            by_expr: dict[str, list] = {}
            for lineno, text, names, node in seeds:
                if names & comp_targets:
                    continue  # fresh binding per comprehension iteration
                by_expr.setdefault(text, []).append((lineno, names, node))
            for text, sites in by_expr.items():
                sites.sort(key=lambda t: t[0])
                for (l1, names, _), (l2, _, node2) in zip(sites, sites[1:]):
                    if not any(l1 < lr <= l2 and nr in names
                               for lr, nr in rebinds):
                        yield ctx.finding(
                            self, node2,
                            f"seed {text!r} already seeded a generator at "
                            f"line {l1} — two generators, one stream",
                        )

            # (b) loop reuse: a seeding inside a loop whose seed expression
            # the loop never changes
            for loop in loops:
                bound_in_loop = _assigned_names(loop)
                for node in ast.walk(loop):
                    if not isinstance(node, ast.Call):
                        continue
                    expr = self._seed_expr(ctx, node)
                    if expr is None:
                        continue
                    names = _loaded_names(expr)
                    if not names & (bound_in_loop | comp_targets):
                        yield ctx.finding(
                            self, node,
                            f"seed {ast.unparse(expr)!r} set inside a loop "
                            "but never changed per iteration — every pass "
                            "restarts the same stream",
                        )

    # -- 4: untagged stdlib seeds --------------------------------------------

    def _untagged_random(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.dotted(node.func) != "random.Random":
                continue
            if not node.args:
                yield ctx.finding(self, node,
                                  "unseeded random.Random() — draws are "
                                  "irreproducible")
                continue
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                text = "".join(v.value for v in arg.values
                               if isinstance(v, ast.Constant)
                               and isinstance(v.value, str))
                if ":" in text:
                    continue
            elif isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) and ":" in arg.value:
                continue
            yield ctx.finding(
                self, node,
                "random.Random seed must use the tagged f\"{seed}:{tag}\" "
                "stream discipline (repro_torch.population.spec) — "
                "int-seeded streams with a shared seed are byte-identical",
            )

    # -- 3: stream-constant collisions (cross-file) ---------------------------

    def check_project(self, contexts, index) -> Iterator[Finding]:
        streams: dict[int, list[tuple[FileContext, ast.AST, str]]] = {}
        for ctx in contexts:
            if not ctx.rel.startswith("src/"):
                continue
            for node in ctx.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id.endswith(STREAM_SUFFIXES) \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, int):
                    streams.setdefault(node.value.value, []).append(
                        (ctx, node, node.targets[0].id)
                    )
        for value, sites in sorted(streams.items()):
            if len(sites) < 2:
                continue
            where = ", ".join(f"{c.rel}:{n.lineno}" for c, n, _ in sites)
            for ctx, node, name in sites:
                yield ctx.finding(
                    self, node,
                    f"stream {name} = {value} collides with another module's "
                    f"({where}) — noise-stream namespaces must be unique",
                )

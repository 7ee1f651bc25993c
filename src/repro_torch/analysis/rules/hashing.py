"""canonical-hash-discipline: one byte encoding per content address.

``population.graph`` node ids, ``obs.ledger`` entry ids and
``scenarios.spec`` cache keys all hash the SAME canonical JSON bytes
(sorted keys, compact separators — ``repro_torch.canon``).  A hand-rolled
``hashlib.sha256(json.dumps(...).encode())`` drifts the moment someone
forgets ``sort_keys`` or leaves the default separators: the same record
then has two addresses, re-traces stop matching, ledgers fork.

Rule: a function (or module body) in src/ that calls both ``json.dumps``
and a ``hashlib`` digest is hand-rolling a content hash — route it
through ``repro_torch.canon.content_hash``/``canonical_json_bytes``
instead.  ``repro_torch.canon`` itself is the one sanctioned definition
site.  tests/ are exempt: tamper tests legitimately re-derive hashes to
cross-check the helpers.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import FileContext, Rule, register_rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graphs import ModuleIndex

def _walk_scope(body):
    """Walk a scope's statements, pruning nested function subtrees (they
    are their own scopes) but not lambdas/comprehensions."""
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


_DIGESTS = frozenset(
    f"hashlib.{n}" for n in
    ("sha256", "sha1", "sha512", "sha384", "md5", "blake2b", "blake2s",
     "sha3_256", "new")
)


@register_rule
class CanonicalHashDiscipline(Rule):
    id = "canonical-hash-discipline"
    contract = ("json.dumps feeding hashlib goes through "
                "repro_torch.canon.content_hash — one byte encoding per address")
    design = "§13.5"

    def check_file(self, ctx: FileContext, index: ModuleIndex) -> Iterator[Finding]:
        if not ctx.rel.startswith("src/") or ctx.module == "repro_torch.canon":
            return
        # scopes: each def's body (nested defs excluded from the parent),
        # plus the module body itself
        scopes: list[tuple[str, list[ast.AST]]] = [("<module>", ctx.tree.body)]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append((node.name, node.body))
        for name, body in scopes:
            dumps, digest = None, None
            for node in _walk_scope(body):
                if not isinstance(node, ast.Call):
                    continue
                dotted = ctx.dotted(node.func)
                if dotted == "json.dumps":
                    dumps = dumps or node
                elif dotted in _DIGESTS:
                    digest = digest or node
            if dumps is not None and digest is not None:
                yield ctx.finding(
                    self, digest,
                    f"{name}() hand-rolls json.dumps + hashlib — use "
                    "repro_torch.canon.content_hash/canonical_json_bytes so the "
                    "byte encoding cannot drift",
                )

"""unaccounted-noise: every DP noise draw flows through core/dp.py.

The RDP accountant's ε is a statement about the noise ``core.dp``
calibrates (``noise_share`` / ``tree_topup_noise``: N(0, (Cσ)²/n) shares,
conservative top-ups).  A ``torch.randn`` scaled by some local sigma
anywhere else is noise the ledger never hears about — the run *looks*
private and isn't.

The port's Gaussian and Laplace draws: ``torch.randn``, ``randn_like``,
``normal``, the ``torch.nn.init`` normal initialisers, ``Tensor.normal_``,
and ``torch.distributions``' ``Normal`` and ``Laplace``.  Host numpy draws
(the data generators, PATE's GNMax votes, which ``run_pate`` accounts
itself) are outside the rule's sight, as they are in the reference's.

Two triggers, src/ only (tests and benchmarks draw normals as fixtures):

  * any such draw outside ``repro_torch.core.dp`` and outside
    ``repro_torch.models`` + ``repro_torch.kernels`` (parameter
    initialisers and kernel references draw normals that are not noise);
  * anywhere at all (models included): a draw scaled by an expression
    mentioning sigma/noise/std/clip — a factor of ``*``, the ``std=`` (or
    second positional) argument of ``torch.normal``/``normal_``/``Normal``,
    the ``scale`` of ``Laplace``, or the ``alpha=`` of an ``add``/``add_``
    that adds the draw.  That is a privacy-noise shape, and it must live
    in core/dp.py.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from repro_torch.analysis.engine import FileContext, Rule, register_rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graphs import ModuleIndex

_NOISE_FNS = frozenset({
    "torch.randn", "torch.randn_like", "torch.normal",
    "torch.nn.init.normal_", "torch.nn.init.trunc_normal_",
    "torch.distributions.Normal", "torch.distributions.Laplace",
    "torch.distributions.normal.Normal",
    "torch.distributions.laplace.Laplace",
})
_NOISE_METHODS = frozenset({"normal_"})
# draws whose scale is an argument: (positional index, keyword names)
_SCALE_ARG = {"normal": (1, ("std", "scale")), "normal_": (1, ("std",)),
              "Normal": (1, ("scale",)), "Laplace": (1, ("scale",))}
_EXEMPT_MODULE = "repro_torch.core.dp"
_INIT_PREFIXES = ("repro_torch.models", "repro_torch.kernels")
_SIGMA_RE = re.compile(r"sigma|noise|(^|[^a-z])std([^a-z]|$)|clip",
                       re.IGNORECASE)


@register_rule
class UnaccountedNoise(Rule):
    id = "unaccounted-noise"
    contract = ("every sigma-scaled Gaussian/Laplace draw lives in "
                "core/dp.py where the accountant calibrates it")
    design = "§13.3"

    @staticmethod
    def _is_draw(ctx: FileContext, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if ctx.dotted(node.func) in _NOISE_FNS:
            return True
        return isinstance(node.func, ast.Attribute) and \
            node.func.attr in _NOISE_METHODS

    @staticmethod
    def _scale_arg(node: ast.Call) -> ast.AST | None:
        name = node.func.attr if isinstance(node.func, ast.Attribute) \
            else getattr(node.func, "id", "")
        if name not in _SCALE_ARG:
            return None
        pos, kws = _SCALE_ARG[name]
        for kw in node.keywords:
            if kw.arg in kws:
                return kw.value
        return node.args[pos] if len(node.args) > pos else None

    def check_file(self, ctx: FileContext, index: ModuleIndex) -> Iterator[Finding]:
        if not ctx.rel.startswith("src/") or ctx.module == _EXEMPT_MODULE:
            return
        init_exempt = ctx.module.startswith(_INIT_PREFIXES)
        # draw node -> the expression that scales it (if any)
        scaled: dict[ast.AST, str] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
                for side, other in ((node.left, node.right),
                                    (node.right, node.left)):
                    if self._is_draw(ctx, side):
                        scaled[side] = ast.unparse(other)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("add", "add_"):
                alpha = [kw.value for kw in node.keywords
                         if kw.arg == "alpha"]
                for arg in node.args:
                    if alpha and self._is_draw(ctx, arg):
                        scaled[arg] = ast.unparse(alpha[0])
        for node in ast.walk(ctx.tree):
            if not self._is_draw(ctx, node):
                continue
            multiplier = scaled.get(node)
            scale = self._scale_arg(node)
            if multiplier is None and scale is not None:
                multiplier = ast.unparse(scale)
            if multiplier is not None and _SIGMA_RE.search(multiplier):
                yield ctx.finding(
                    self, node,
                    f"draw scaled by {multiplier!r} outside core/dp.py — "
                    "noise bypassing the accountant/ledger",
                )
            elif not init_exempt:
                yield ctx.finding(
                    self, node,
                    "Gaussian/Laplace draw outside core/dp.py (and outside "
                    "the models/kernels initialiser exemption) — route "
                    "noise through repro_torch.core.dp",
                )

"""Model-aware clipped-grad-sum seam for the fused round-step (DESIGN.md §12).

Counterpart of ``repro.arms.clipping``.  Every DP arm needs the same
primitive inside its cohort step: the sum of per-example-clipped gradients
over one silo's Poisson batch, plus the mask-weighted mean loss.  Two
implementations exist:

- ``core.dp.per_example_clipped_grad_sum`` — faithful, model-agnostic,
  one gradient per example (``torch.func.vmap`` of ``grad``, microbatched).
- ``core.ghost.ghost_clipped_grad_sum`` — ghost clipping: exact
  per-example norms from collector ``autograd.Function``s in one batched
  backward (the dense layers' norms from the ``ghost_norm`` kernel on the
  card), no per-example gradient ever materialised.  Dense decoder stacks
  with untied embeddings only.

Which one a model gets is a *capability*: a ``Model`` that can take the
ghost path carries a ``GhostCapability`` in ``Model.ghost``.
``ArmConfig.clipping`` selects among {"auto", "ghost", "per-example"} and
is validated loudly in ``arms.run`` — asking for "ghost" on a model
without the capability is a ``ValueError`` at validation, never a silent
fallback mid-round.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

CLIPPING_MODES = ("auto", "ghost", "per-example")


@dataclasses.dataclass(frozen=True)
class GhostCapability:
    """Attached to ``Model.ghost`` when the ghost clipping path is exact:
    ``cfg`` is the transformer ModelConfig the ghost forward runs;
    ``chunk_size`` bounds residual-activation memory (None = the whole silo
    batch in one chunk)."""

    cfg: Any
    chunk_size: int | None = None


def resolve(model, cfg) -> str:
    """The effective clipping path ("ghost" | "per-example").

    Loud: ``clipping="ghost"`` on a model without the capability raises
    instead of silently degrading to the per-example path.
    """
    mode = getattr(cfg, "clipping", "auto")
    if mode not in CLIPPING_MODES:
        raise ValueError(
            f"unknown clipping mode {mode!r}; expected one of {CLIPPING_MODES}"
        )
    cap = getattr(model, "ghost", None)
    if mode == "ghost":
        if cap is None:
            raise ValueError(
                "clipping='ghost' requires a model with a GhostCapability "
                "(dense decoder stack, untied embeddings); this model does "
                "not declare one — use clipping='auto' or 'per-example'"
            )
        return "ghost"
    if mode == "per-example":
        return "per-example"
    return "ghost" if cap is not None else "per-example"


def clipped_grad_sum_fn(model, cfg, pad: int) -> Callable:
    """Build ``fn(params, batch, mask) -> (grad_sum, loss)`` for one silo.

    ``batch`` is the arm-side ``{"x": [B, ...], "y": [B]}`` dict of tensors;
    ``mask`` is the [B] Poisson-pad row mask.  The ghost branch adapts it to
    the transformer token layout and drops the norms from the return, so
    both branches share one signature.
    """
    from repro_torch.arms.fused import example_sum
    from repro_torch.core import dp as dp_lib

    if resolve(model, cfg) == "per-example":
        micro = min(cfg.dp.microbatch_size, pad)

        def per_example(params, batch, mask):
            return dp_lib.per_example_clipped_grad_sum(
                model.loss_fn, params, batch,
                clip_norm=cfg.dp.clip_norm, microbatch_size=micro, mask=mask,
                reduce=example_sum,
            )

        return per_example

    from repro_torch.core import ghost as ghost_lib

    cap = model.ghost

    def ghost(params, batch, mask):
        gbatch = {"tokens": batch["x"].long(), "labels": batch["y"].long()}
        grads, loss, _norms = ghost_lib.ghost_clipped_grad_sum(
            cap.cfg, params, gbatch, clip_norm=cfg.dp.clip_norm,
            chunk_size=cap.chunk_size, mask=mask, reduce=example_sum)
        return grads, loss

    return ghost

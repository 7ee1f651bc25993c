"""The DeCaPH training step as one function — the one-card fast path.

Counterpart of ``repro.core.decaph_step``.  One call runs a whole DeCaPH
round body on the batch it is given: per-example clipped gradients summed
(the sum a SecAgg round would deliver), ONE aggregate noise draw
N(0, (C sigma)^2) — identically distributed to the sum of the paper's
per-participant shares — the 1/||B^t|| mean and the optimizer update.
The reference's version is jit/pjit-able and shards the example axis over
("pod", "data"); this one runs eagerly on the device of its tensors (the
sharded form belongs with the multi-card work).

The noise comes from a ``torch.Generator`` that the caller passes where
the reference passes a JAX key; its draws follow the same law, not the
same bits (``core.dp``).

Beyond the reference's modes, mode "ghost" takes the clipped sum from a
caller's ``ghost_grad_sum`` (``core.ghost.ghost_clipped_grad_sum`` bound
to a model config) and noises, averages and applies it as "per_example"
does: the launch layer's train programs are this one step in all three
of their modes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import dp as dp_lib
from repro_torch.optim import Optimizer
from repro_torch.tree import Tree, tree_map


@dataclasses.dataclass(frozen=True)
class DeCaPHStepConfig:
    dp: dp_lib.DPConfig
    mode: str = "per_example"   # per_example | ghost | none (FL arm) | group
    global_batch: int = 256      # ||B^t|| used for the 1/||B^t|| mean
    accum_dtype: Any = torch.float32


def make_train_step(
    batched_loss_fn: Callable[[Tree, Tree], torch.Tensor],
    per_example_loss_fn: Callable[[Tree, Tree], torch.Tensor],
    optimizer: Optimizer,
    cfg: DeCaPHStepConfig,
    ghost_grad_sum: Callable[[Tree, Tree], tuple[Tree, torch.Tensor]]
    | None = None,
    trace_repeat: Callable | None = None,
):
    """Build ``train_step(params, opt_state, batch, generator) ->
    (params', opt_state', metrics)``.

    Args:
      batched_loss_fn: (params, batch) -> scalar mean loss (mode "none" and
        "group").
      per_example_loss_fn: (params, one example) -> scalar (mode
        "per_example"; called under ``torch.func.vmap``).
      optimizer: a ``repro_torch.optim`` Optimizer.
      cfg: the step's config (clip norm, sigma and microbatch in cfg.dp).
      ghost_grad_sum: (params, batch) -> (clipped gradient sum, mean
        loss), with per-example norms by ghost clipping (mode "ghost").
      trace_repeat: a shape-only trace's counter (mode "per_example";
        ``dp.per_example_clipped_grad_sum``'s).

    The batch's leading axis is the example axis; ``generator`` draws the
    aggregate noise (unused in mode "none").
    """
    if cfg.mode == "ghost" and ghost_grad_sum is None:
        raise ValueError('mode "ghost" needs a ghost_grad_sum')

    def train_step(params, opt_state, batch, generator):
        if cfg.mode in ("per_example", "ghost"):
            if cfg.mode == "ghost":
                g_sum, mean_loss = ghost_grad_sum(params, batch)
            else:
                g_sum, mean_loss = dp_lib.per_example_clipped_grad_sum(
                    per_example_loss_fn, params, batch,
                    clip_norm=cfg.dp.clip_norm,
                    microbatch_size=cfg.dp.microbatch_size,
                    accum_dtype=cfg.accum_dtype,
                    trace_repeat=trace_repeat,
                )
            # the aggregate noise draw (== the sum of H participant shares)
            g_sum = dp_lib.tree_add_noise(
                g_sum, generator, clip_norm=cfg.dp.clip_norm,
                noise_multiplier=cfg.dp.noise_multiplier, n_shares=1,
            )
            grads = tree_map(lambda x: x / float(cfg.global_batch), g_sum)
        elif cfg.mode == "group":
            # group-level clipping (beyond the paper, cheap): clip the
            # batch's mean gradient and scale the noise to it; a weaker
            # per-record guarantee, never used for the paper's claims
            grads, loss = torch.func.grad_and_value(
                lambda p: batched_loss_fn(p, batch))(params)
            norm = dp_lib.global_l2_norm(grads)
            factor = dp_lib.clip_factor(norm, cfg.dp.clip_norm)
            # promoted as JAX promotes (a 0-d float32 widens a bf16 leaf)
            grads = tree_map(lambda x: x.to(torch.promote_types(
                x.dtype, factor.dtype)) * factor, grads)
            grads = dp_lib.tree_add_noise(
                grads, generator,
                clip_norm=cfg.dp.clip_norm / cfg.global_batch,
                noise_multiplier=cfg.dp.noise_multiplier, n_shares=1,
            )
            mean_loss = loss
        elif cfg.mode == "none":
            grads, mean_loss = torch.func.grad_and_value(
                lambda p: batched_loss_fn(p, batch))(params)
        else:
            raise ValueError(f"unknown mode {cfg.mode!r}")

        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = {
            "loss": mean_loss,
            "grad_norm": dp_lib.global_l2_norm(grads),
        }
        return new_params, new_opt, metrics

    return train_step

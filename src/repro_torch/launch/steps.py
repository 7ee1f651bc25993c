"""Step factories: one place that builds the programs the train CLI, the
serve CLI and the roofline run.

Counterpart of ``repro.launch.steps`` on one card.  Three program kinds
per (arch, shape):

  * train   — the full DeCaPH round body, ``core.decaph_step``'s step:
    per-example clipped gradients (the faithful path through
    ``torch.func.vmap`` microbatches, or ghost clipping, whose every dense
    collector site is a ``ghost_norm`` launch on the card), one aggregate
    noise draw, the optimizer update;
  * prefill — forward -> logits;
  * decode  — one-token decode against a seq_len KV cache.

A ``Program``'s ``args`` are meta tensors (``configs.shapes``,
``transformer.param_specs``, the optimizer's ``init`` of those): nothing
is allocated, at any width.  Each builder takes the ``device`` its
program runs on where the reference takes a mesh, so a MoE arch routes
its tokens as one group (the reference's ``moe_groups`` is the mesh's
data axis, 1 on one card).  ``device="meta"`` builds a shape-only
program (its train step takes ``generator=None``): ``launch.dryrun``
places the specs on a mesh as DTensors and runs it there, under the
reference's sharding ``policy`` and activation rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs.shapes import input_specs
from repro_torch.core import dp as dp_lib
from repro_torch.core.decaph_step import DeCaPHStepConfig, make_train_step
from repro_torch.core.ghost import ghost_clipped_grad_sum
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_map

DP_MODES = ("per_example", "ghost", "none")


@dataclasses.dataclass
class Program:
    """A runnable program and the meta-tensor specs of its arguments.

    ``fn(*args)`` for prefill and decode; a train program's ``fn`` takes
    one more argument after ``args``, the ``torch.Generator`` (on the
    program's device) that draws the step's noise.
    """

    fn: Any
    args: tuple
    kind: str                     # train | prefill | decode
    cfg: Any
    meta: dict


def _to(device: torch.device, tree):
    """The inputs on the program's device (a batch is born on the host)."""
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


def _device(device) -> torch.device:
    """The program's device: the meta device for a shape-only program."""
    return torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)


def _one_group(cfg, groups: int = 1):
    """One card is one data shard: a MoE arch routes as one token group
    (a mesh's dry run routes as ``groups``, the data extent, as the
    reference does)."""
    return cfg.replace(moe_groups=groups) if cfg.n_experts else cfg


def build_train_program(cfg, shape_name: str, device=DEFAULT_DEVICE,
                        dp_mode: str | None = None,
                        moe_groups: int = 1) -> Program:
    device = _device(device)
    cfg, batch_specs, kind = input_specs(cfg, shape_name)
    if kind != "train":
        raise ValueError(f"{shape_name} is a {kind} shape")
    shape = INPUT_SHAPES[shape_name]
    global_batch = shape["global_batch"]
    mode = dp_mode or "per_example"     # the paper-faithful default
    if mode not in DP_MODES:
        raise ValueError(f"unknown dp_mode {mode!r} (one of {DP_MODES})")
    cfg = _one_group(cfg, moe_groups)

    params_specs = tf.param_specs(cfg)
    opt = get_optimizer(cfg.optimizer, cfg.lr)
    opt_specs = opt.init(params_specs)
    # cfg.dp_microbatch examples a vmapped microbatch (the reference's
    # global microbatch per scan step)
    micro = max(1, min(cfg.dp_microbatch, global_batch))

    def ghost_grad_sum(params, batch):
        # exact per-example norms from one batched backward (the
        # collector), then one clip-weighted backward: core/ghost.py
        g_sum, loss, _ = ghost_clipped_grad_sum(
            cfg, params, batch, clip_norm=cfg.dp_clip,
            chunk_size=min(cfg.ghost_chunk, global_batch))
        return g_sum, loss

    # the divisor is the shape's batch, whatever batch fn is given
    step = make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b),
        lambda p, ex: tf.per_example_loss_fn(cfg, p, ex), opt,
        DeCaPHStepConfig(dp=dp_lib.DPConfig(
            clip_norm=cfg.dp_clip, noise_multiplier=cfg.dp_sigma,
            microbatch_size=micro), mode=mode, global_batch=global_batch),
        ghost_grad_sum=ghost_grad_sum)

    def train_step(params, opt_state, batch, generator):
        return step(params, opt_state, _to(device, batch), generator)

    meta = {"global_batch": global_batch, "seq_len": shape["seq_len"],
            "dp_mode": mode, "microbatch": micro}
    return Program(train_step, (params_specs, opt_specs, batch_specs),
                   "train", cfg, meta)


def build_prefill_program(cfg, shape_name: str, device=DEFAULT_DEVICE,
                          moe_groups: int = 1) -> Program:
    device = _device(device)
    cfg, batch_specs, kind = input_specs(cfg, shape_name)
    if kind != "prefill":
        raise ValueError(f"{shape_name} is a {kind} shape")
    shape = INPUT_SHAPES[shape_name]
    cfg = _one_group(cfg, moe_groups)

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = tf.forward(cfg, params, _to(device, batch))
        return logits

    meta = {"global_batch": shape["global_batch"], "seq_len": shape["seq_len"]}
    return Program(prefill, (tf.param_specs(cfg), batch_specs), "prefill",
                   cfg, meta)


def build_decode_program(cfg, shape_name: str, device=DEFAULT_DEVICE,
                         moe_groups: int = 1) -> Program:
    device = _device(device)
    cfg, specs, kind = input_specs(cfg, shape_name)
    if kind != "decode":
        raise ValueError(f"{shape_name} is a {kind} shape")
    shape = INPUT_SHAPES[shape_name]
    cfg = _one_group(cfg, moe_groups)

    @torch.no_grad()
    def serve_step(params, cache, tokens, index):
        """``index``: an int, or a 0-d int tensor (read on the host).  The
        cache is updated in place and returned."""
        return tf.decode_step(cfg, params, cache, _to(device, tokens),
                              int(index))

    args = (tf.param_specs(cfg), specs["cache"], specs["tokens"],
            specs["index"])
    meta = {"global_batch": shape["global_batch"], "seq_len": shape["seq_len"]}
    return Program(serve_step, args, "decode", cfg, meta)


def build_program(cfg, shape_name: str, device=DEFAULT_DEVICE,
                  dp_mode: str | None = None, moe_groups: int = 1
                  ) -> Program:
    kind = INPUT_SHAPES[shape_name]["kind"]
    if kind == "train":
        return build_train_program(cfg, shape_name, device, dp_mode,
                                   moe_groups)
    if kind == "prefill":
        return build_prefill_program(cfg, shape_name, device, moe_groups)
    return build_decode_program(cfg, shape_name, device, moe_groups)

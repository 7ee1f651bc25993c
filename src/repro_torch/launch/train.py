"""End-to-end DeCaPH training CLI on one card.

Counterpart of ``repro.launch.train``.  Runs the DeCaPH train step
(``core.decaph_step``: per-example clipped gradients in microbatches of
``batch // 2``, one aggregate noise draw, the config's optimizer) on the
device it is given.  Each step is one DeCaPH round: every synthetic
hospital (``--n-silos``) contributes ``batch // n_silos`` sequences of its
own token stream, and the 1/||B^t|| mean divides by ``--batch``.  The
reference maps the hospitals onto its mesh's data axis, so its gradient
all-reduce is the secure-aggregation sum; on one card the sum is the
clipped-gradient sum itself.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 8 --seq 256 [--scale 100m] [--no-dp] \\
      [--device cuda]

It prints the reference's log lines, with the device where the reference
prints its mesh, and writes a ``repro-ckpt-v1`` file of the final
parameters (in the reference's tree) with ``--checkpoint``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.configs.base import dense_stack
from repro_torch.convert import params_to_tree
from repro_torch.core.accountant import RDPAccountant
from repro_torch.core.decaph_step import DeCaPHStepConfig, make_train_step
from repro_torch.core.dp import DPConfig, noise_seed
from repro_torch.data import make_lm_stream
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves


def scaled_config(arch: str, scale: str):
    if scale == "full":
        return get_config(arch)
    if scale == "smoke":
        return get_smoke_config(arch)
    if scale == "100m":
        # ~100M-param member of the arch family for the e2e example
        cfg = get_smoke_config(arch)
        return cfg.replace(
            d_model=512, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=1536,
            vocab_size=8192,
            stack=dense_stack(12) if cfg.arch_type == "dense" else cfg.stack,
            n_layers=12 if cfg.arch_type == "dense" else cfg.n_layers,
        )
    raise ValueError(scale)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", choices=list(ARCHITECTURES), default="smollm-360m")
    p.add_argument("--scale", default="smoke", choices=["full", "smoke", "100m"])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--no-dp", action="store_true")
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--sigma", type=float, default=0.8)
    p.add_argument("--eps-budget", type=float, default=None)
    p.add_argument("--n-silos", type=int, default=4,
                   help="synthetic hospitals feeding the batch")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Train; returns the run's ``losses`` (one float a step), ``epsilon``
    (0.0 without DP), ``steps`` run and the final ``params``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = scaled_config(args.arch, args.scale)
    if args.lr:
        cfg = cfg.replace(lr=args.lr)
    print(f"device={dev} arch={args.arch} scale={args.scale} "
          f"dp={'off' if args.no_dp else 'on'}")

    params = tf.init(cfg, 0, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"params: {n_params/1e6:.1f}M")
    opt = get_optimizer(cfg.optimizer, cfg.lr)
    opt_state = opt.init(params)

    # Every silo contributes batch/n_silos examples per round (one DeCaPH
    # round == one step); streams differ per silo (covariate shift via seed).
    streams = [
        make_lm_stream(cfg.vocab_size, args.seq, seed=17 * i + 1)
        for i in range(args.n_silos)
    ]
    acct = None
    if not args.no_dp:
        acct = RDPAccountant(
            sampling_rate=min(1.0, args.batch / (args.batch * 50)),
            noise_multiplier=args.sigma, delta=1e-5,
        )
    step_fn = make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b),
        lambda p, ex: tf.per_example_loss_fn(cfg, p, ex),
        opt,
        DeCaPHStepConfig(
            dp=DPConfig(clip_norm=args.clip, noise_multiplier=args.sigma,
                        microbatch_size=max(1, args.batch // 2)),
            mode="none" if args.no_dp else "per_example",
            global_batch=args.batch),
    )

    losses = []
    t0 = time.time()
    step = -1
    for step in range(args.steps):
        per_silo = max(1, args.batch // args.n_silos)
        parts = [s.batch(step, per_silo) for s in streams]
        batch = {
            k: torch.from_numpy(np.concatenate([p[k] for p in parts])).to(dev)
            for k in parts[0]
        }
        gen = torch.Generator(device=dev)
        gen.manual_seed(noise_seed(0, 1000 + step))
        params, opt_state, metrics = step_fn(params, opt_state, batch, gen)
        losses.append(float(metrics["loss"]))
        if acct:
            acct.step()
        if step % args.log_every == 0 or step == args.steps - 1:
            eps = acct.epsilon() if acct else 0.0
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"eps {eps:.3f} ({time.time()-t0:.1f}s)")
        if acct and args.eps_budget and acct.epsilon() > args.eps_budget:
            print(f"privacy budget {args.eps_budget} reached at step {step}")
            break
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params_to_tree(params),
                        step=args.steps)
        print("checkpoint written:", args.checkpoint)
    return {"losses": losses, "epsilon": acct.epsilon() if acct else 0.0,
            "steps": step + 1, "params": params}


if __name__ == "__main__":
    main()

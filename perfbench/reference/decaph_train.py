"""Plain reference of DeCaPH training rounds (the paper's Algorithm 2 with
distributed noise), followed from the same weights and silos the program
was given.

Each round, as the protocol states it: every hospital draws its Poisson
batch (one uniform per example, kept where below q = B / n, from one
generator seeded with the protocol's seed and read in (round, ascending
hospital) order); every real example's gradient of its token-mean loss is
clipped to L2 norm C over the whole model; each hospital adds its noise
share, N(0, (C sigma)^2 / H) a coordinate; the sum over hospitals, divided
by the aggregate batch, is one SGD step of rate lr.  A hospital's loss is
the mean over its real examples (0 for an empty draw); the round's is the
mean over hospitals.

The noise shares are drawn again by the rule the port documents
(``repro_torch.core.dp``): a generator on the device seeded from the
SeedSequence words (seed, 17 + round, hospital), one float32 normal draw
per leaf in the tree's order.  The noise is about a thousand times the
clipped sum, so the reference hands it back, round by round, for the
comparison to take it out of the program's states.

One example at a time, in float32 with TF32 off; ``mm`` is the precision
of every product (``transformer.tf32_mm``, ``bf16_mm`` or ``fp8_mm`` for
a control).  ``half`` keeps the first half of each hospital's draw (a
planted fault).  ``start`` follows from a later round: the draws of the
rounds before it are read and left, and the noise is that round's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import transformer as plain

NOISE_STREAM = 17


def noise_seed(*words: int) -> int:
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0])


def _leaves(tree: dict) -> list[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _like(tree: dict, leaves) -> dict:
    it = iter(leaves)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(tree)


def follow(mc: dict, mix: dict, params0: dict, silos, protocol_seed: int,
           rounds: int = 3, start: int = 0, mm=torch.matmul,
           half: bool = False) -> dict:
    """``rounds`` rounds from round ``start``, from the weights
    ``params0`` held before it.  Returns, per round, ``loss`` and ``agg``
    (the aggregate batch); per leaf, ``grad1`` (the norm of the first
    round's clipped sum over its aggregate batch) and ``change`` (the
    norm of the noise-free change of the weights over the rounds); and
    the noise, as lists of leaves: ``noise1`` (the first round's sum of
    shares over its aggregate batch) and ``noise_change`` (lr times that,
    summed over the rounds)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(mc, mix, params0, silos, protocol_seed, rounds, start,
                       mm, half)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _follow(mc, mix, params0, silos, protocol_seed, rounds, start, mm,
            half):
    dev = _leaves(params0)[0].device
    p = [t.detach().float().clone().requires_grad_(True)
         for t in _leaves(params0)]
    zeros = lambda: [torch.zeros_like(t, requires_grad=False) for t in p]
    n_total = sum(len(x) for x, _ in silos)
    rate = mix["batch_size"] / n_total
    clip, lr = mix["clip_norm"], mix["lr"]
    std = clip * mix["noise_multiplier"] / math.sqrt(len(silos))
    rng = np.random.default_rng(protocol_seed)
    for _ in range(start):
        for x, _y in silos:
            rng.random(len(x))
    signal_change, noise_change = zeros(), zeros()
    out = {"loss": [], "agg": []}
    for t in range(start, start + rounds):
        signal, noise, agg, losses = zeros(), zeros(), 0, []
        for i, (x, y) in enumerate(silos):
            rows = np.nonzero(rng.random(len(x)) < rate)[0]
            if half:
                rows = rows[:len(rows) // 2]
            row_loss = []
            for r in rows:
                tok = torch.from_numpy(x[r:r + 1]).to(dev)
                lab = torch.from_numpy(y[r:r + 1]).to(dev)
                loss = plain.row_losses(mc, _like(params0, p), tok, lab, mm)[0]
                grads = torch.autograd.grad(loss, p)
                norm = torch.sqrt(sum(g.square().sum() for g in grads))
                factor = torch.clamp(clip / torch.clamp(norm, min=1e-12),
                                     max=1.0)
                for s, g in zip(signal, grads):
                    s.add_(g * factor)
                row_loss.append(loss.detach())
            losses.append(float(torch.stack(row_loss).mean()) if row_loss
                          else 0.0)
            gen = torch.Generator(device=dev)
            gen.manual_seed(noise_seed(protocol_seed, NOISE_STREAM + t, i))
            for nz, leaf in zip(noise, p):
                nz.add_(torch.randn(leaf.shape, generator=gen,
                                    dtype=torch.float32, device=dev) * std)
            agg += len(rows)
        out["loss"].append(float(np.mean(losses)))
        out["agg"].append(agg)
        if agg == 0:      # a void round: no step
            continue
        with torch.no_grad():
            for leaf, s, nz, sc, nc in zip(p, signal, noise, signal_change,
                                           noise_change):
                s.div_(agg)
                nz.div_(agg)
                leaf.sub_(lr * (s + nz))
                sc.sub_(lr * s)
                nc.add_(lr * nz)
        if t == start:
            out["grad1"] = [float(s.double().norm()) for s in signal]
            out["noise1"] = noise
        del signal
    out["change"] = [float(c.double().norm()) for c in signal_change]
    out["noise_change"] = noise_change
    return out

"""DP gradient mechanics for DeCaPH (paper Algorithm 2 + Step 5 aggregation).

Counterpart of ``repro.core.dp``:

  * per-example gradients with L2 clipping (``torch.func.vmap`` of
    ``grad`` over microbatches, so memory stays bounded at
    ``microbatch_size x |params|``) — the faithful path;
  * ghost norms of a dense layer with 2-D inputs (the sequence case is the
    ``ghost_norm`` kernel, called from ``core.ghost``);
  * distributed noise shares: every participant adds N(0, (C sigma)^2 / H)
    so the secure **sum** carries the paper's N(0, (C sigma)^2), and the
    top-up that restores that variance when shares are lost to dropouts.

Noise comes from an explicit ``torch.Generator``.  The reference derives
its keys with ``jax.random.fold_in``; a torch generator cannot reproduce
threefry's bits, so the port's draws differ from the reference's while
following the same law (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.models.placement import rows
from repro_torch.tree import Tree, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Privacy hyperparameters for one DeCaPH training run.

    Attributes:
      clip_norm: per-example L2 clipping norm C.
      noise_multiplier: sigma; the aggregate noise is N(0, (C sigma)^2).
      delta: DP delta (for accounting).
      microbatch_size: examples per vmapped microbatch (faithful path).

    Clipped sums and noise are float32.
    """

    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5
    microbatch_size: int = 16


def global_l2_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over every leaf of a tree (fp32 accumulate)."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_factor(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, C / norm) — the paper's line 3 scale (Algorithm 1 line 6)."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def per_example_clipped_grad_sum(
    loss_fn: Callable[[Tree, Tree], torch.Tensor],
    params: Tree,
    batch: Tree,
    *,
    clip_norm: float,
    microbatch_size: int = 16,
    mask: torch.Tensor | None = None,
    accum_dtype: torch.dtype = torch.float32,
    reduce: Callable | None = None,
    trace_repeat: Callable | None = None,
) -> tuple[Tree, torch.Tensor]:
    """Sum of per-example L2-clipped gradients (paper Algorithm 2, lines 1-3).

    ``loss_fn(params, example)`` is the loss of ONE example (called under
    ``torch.func.vmap``; the leading axis of ``batch`` is the example
    axis).  ``mask`` ([B] of 0/1) drops the pad rows of a Poisson batch:
    they contribute nothing.  Returns (sum of clipped per-example grads,
    mean unclipped loss over real examples) =
    (Σ_i clip_i·g_i·mask_i, Σ(loss·mask) / max(Σmask, 1)); both sums
    accumulate in ``accum_dtype`` (float32 unless asked), as the
    reference's do.  ``reduce``, where the batch's rows are split over
    ranks, maps (gradient sum, loss sum, real-row count) to their sums over
    the ranks before the mean is taken.

    ``trace_repeat`` is for a shape-only trace (``launch.dryrun``), whose
    tensors are all on the meta device: ``trace_repeat(n)`` is a context
    in which a counter counts everything n times, and only the first of
    the n microbatches runs, within it.  Each runs the same ops on the
    same shapes (the batch is padded to a multiple of their size), so the
    counts are the whole loop's.  Any tensor with values is refused.
    """
    if trace_repeat is not None and not all(
            x.is_meta for x in tree_leaves(params) + tree_leaves(batch)
            + [mask] if isinstance(x, torch.Tensor)):
        raise ValueError("trace_repeat runs one microbatch of n: meta "
                         "tensors only")
    params = tree_map(torch.Tensor.detach, params)
    batch_size = tree_leaves(batch)[0].shape[0]
    dev = tree_leaves(params)[0].device
    if mask is None:
        mask = torch.ones((batch_size,), dtype=torch.float32, device=dev)
    m = microbatch_size
    if batch_size % m:
        # pad batch and mask to a multiple of the microbatch size
        pad = m - batch_size % m
        batch = tree_map(lambda x: torch.cat(
            [x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)]), batch)
        mask = torch.cat([mask, torch.zeros((pad,), dtype=mask.dtype,
                                            device=mask.device)])
        batch_size += pad

    grad_and_loss = torch.func.grad_and_value(loss_fn)

    def one_example(ex, w):
        g, loss = grad_and_loss(params, ex)
        scale = clip_factor(global_l2_norm(g), clip_norm) * w
        g = tree_map(lambda x: x * scale.to(x.dtype), g)
        return g, loss * w

    per_micro = torch.func.vmap(one_example)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                         device=p.device), params)
    loss_acc = torch.zeros((), dtype=accum_dtype, device=dev)
    starts = range(0, batch_size, m)
    for start in starts:
        with (trace_repeat(len(starts)) if trace_repeat
              else contextlib.nullcontext()):
            mb = tree_map(lambda x: rows(x, start, start + m), batch)
            g, losses = per_micro(mb, rows(mask, start, start + m))
            acc = tree_map(lambda a, x: a + torch.sum(x.to(accum_dtype),
                                                      dim=0), acc, g)
            loss_acc = loss_acc + torch.sum(losses)
        if trace_repeat:
            break
    n_real = torch.sum(mask)
    if reduce is not None:
        acc, loss_acc, n_real = reduce((acc, loss_acc, n_real))
    return acc, loss_acc / torch.clamp(n_real, min=1.0)


def noise_seed(*entropy: int) -> int:
    """A generator seed from a tuple of non-negative ints — the port's
    counterpart of ``fold_in(fold_in(key(seed), salt), index)``."""
    state = np.random.SeedSequence([int(e) for e in entropy]).generate_state(
        1, np.uint64)
    return int(state[0])


def noise_share(
    generator: torch.Generator,
    template: Tree,
    *,
    clip_norm: float,
    noise_multiplier: float,
    n_shares: int = 1,
) -> Tree:
    """One participant's Gaussian noise share (Algorithm 2 line 4).

    Each of ``n_shares`` participants draws N(0, (C sigma)^2 / H); the sum
    then carries exactly N(0, (C sigma)^2) — the paper's distributed-DP
    trick.  Leaves are drawn in tree order from ``generator``, on its
    device.  A shape-only program (a template on the meta device, as a
    dry run traces it) takes ``generator=None`` and draws nothing.
    """
    std = clip_norm * noise_multiplier / math.sqrt(float(n_shares))
    device = generator.device if generator is not None else \
        tree_leaves(template)[0].device
    if generator is None and device.type != "meta":
        raise ValueError("noise needs a generator (None only for a "
                         "template on the meta device)")
    noised = [torch.randn(x.shape, generator=generator, dtype=torch.float32,
                          device=device) * std
              for x in tree_leaves(template)]
    return tree_unflatten(template, noised)


def tree_add_noise(tree: Tree, generator: torch.Generator, *,
                   clip_norm: float, noise_multiplier: float,
                   n_shares: int = 1) -> Tree:
    """tree + one noise share (the sum promotes like the reference's)."""
    nz = noise_share(generator, tree, clip_norm=clip_norm,
                     noise_multiplier=noise_multiplier, n_shares=n_shares)
    return tree_map(torch.add, tree, nz)


# The stream word of dropout noise top-ups, so a top-up draw never shares a
# seed with a participant's noise share (arms use small words like 17 + t).
# The reference's TOPUP_SALT value, here a SeedSequence word (not a JAX
# fold_in salt: the two packages share no key namespace).
TOPUP_STREAM = 1_000_003


def tree_topup_noise(template: Tree, generator: torch.Generator, *,
                     clip_norm: float, noise_multiplier: float,
                     missing: int, n_shares: int) -> Tree:
    """Conservative noise top-up when ``missing`` of ``n_shares`` noise
    shares were lost mid-round.

    Each share carries N(0, (C sigma)^2 / n); losing ``missing`` of them
    leaves the delivered sum under-noised, with variance
    (C sigma)^2 (n - missing) / n.  An independent
    N(0, (C sigma)^2 missing / n) draw restores the full-cohort variance
    the accountant assumed (Gaussian variances add).  Float32 leaves of
    ``template``'s shapes, drawn in tree order from ``generator``, on its
    device.
    """
    if not 0 < missing <= n_shares:
        raise ValueError(
            f"need 0 < missing <= n_shares (got {missing}/{n_shares})"
        )
    std = clip_norm * noise_multiplier * math.sqrt(missing / float(n_shares))
    noise = [torch.randn(x.shape, generator=generator, dtype=torch.float32,
                         device=generator.device) * std
             for x in tree_leaves(template)]
    return tree_unflatten(template, noise)

# ---------------------------------------------------------------------------
# Ghost clipping: per-example grad norms without per-example grads.
# ---------------------------------------------------------------------------

def ghost_norms_2d(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-example sq-norm of the weight grad of a dense layer, 2D inputs.

    For y = a @ W (a: [B, d_in], cotangent g: [B, d_out]) the per-example
    weight gradient is outer(a_i, g_i) with Frobenius norm^2 =
    |a_i|^2 * |g_i|^2 — O(B(d_in+d_out)) instead of O(B d_in d_out).
    """
    return torch.sum(a.float() ** 2, -1) * torch.sum(g.float() ** 2, -1)

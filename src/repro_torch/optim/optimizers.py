"""Optimizers as (init, update) pairs over parameter trees.

Counterpart of ``repro.optim.optimizers``, kept optax-shaped as the
reference is: ``update(grads, state, params) -> (new_params, new_state)``
over the port's dict trees (``repro_torch.tree``), every function pure
(no tensor is updated in place).  Each update follows the reference's
float32 arithmetic in the reference's order: moments and factors are
float32 whatever the parameters' dtype, and the step is cast to a
parameter's dtype before it is subtracted.  Adafactor's factored second
moments hold O(rows + cols) float32 values per matrix where Adam holds 8
bytes per parameter, which is what lets the 340B and 671B configs name it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import Tree, tree_device, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple[Tree, Any]]
    name: str = "opt"


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar ``x`` as JAX applies it to an array like ``t``:
    weakly typed, so rounded to ``t``'s dtype first (bfloat16's 0.1 is
    0.10009765625).  Torch would multiply a bfloat16 tensor by the float32
    value; the rounded one is exact in float32, so both then compute the
    same product and round it once."""
    return torch.tensor(x, dtype=t.dtype).item()


def _count0(params: Tree) -> torch.Tensor:
    """The step counter: a 0-d int32 tensor on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=tree_device(params))


def sgd(lr: float, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        new = tree_map(
            lambda p, g: p - _weak(lr, p) * (g.to(p.dtype)
                                             + _weak(weight_decay, p) * p),
            params, grads,
        )
        return new, state

    return Optimizer(init, update, "sgd")


def momentum(lr: float, beta: float = 0.9, weight_decay: float = 0.0
             ) -> Optimizer:
    def init(params):
        return tree_map(_zeros32, params)

    def update(grads, state, params):
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        new_p = tree_map(
            lambda p, m: p - _weak(lr, p) * (m.to(p.dtype)
                                             + _weak(weight_decay, p) * p),
            params, new_m,
        )
        return new_p, new_m

    return Optimizer(init, update, "momentum")


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor


def adamw(
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return AdamState(tree_map(_zeros32, params),
                         tree_map(_zeros32, params), _count0(params))

    def update(grads, state, params):
        count = state.count + 1
        c = count.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
            state.nu, grads)
        mu_hat_scale = 1.0 / (1 - b1 ** c)
        nu_hat_scale = 1.0 / (1 - b2 ** c)

        def upd(p, m, v):
            step = lr * (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale)
                                              + eps)
            decay = _weak(lr * weight_decay, p) * p
            return (p - (step + decay).to(p.dtype)).to(p.dtype)

        new_p = tree_map(upd, params, mu, nu)
        return new_p, AdamState(mu, nu, count)

    return Optimizer(init, update, "adamw")


class AdafactorState(NamedTuple):
    vr: Tree      # row factors (or the full v of a leaf below 2-D)
    vc: Tree      # column factors (or a 0-d zero)
    count: torch.Tensor


def _is_matrix(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored Adafactor (Shazeer & Stern 2018), float32 factors.

    Matrices (any leaf of 2 or more dims; the last two are rows and
    columns) store row and column second-moment factors; vectors and
    scalars store the full second moment.  No first moment (beta1 = 0).
    """

    def init(params):
        def vr_init(p):
            if _is_matrix(p):
                return torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device)
            return _zeros32(p)

        def vc_init(p):
            if _is_matrix(p):
                return torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device)
            return torch.zeros((), dtype=torch.float32, device=p.device)

        return AdafactorState(tree_map(vr_init, params),
                              tree_map(vc_init, params), _count0(params))

    def update(grads, state, params):
        count = state.count + 1
        c = count.float()
        beta2 = 1.0 - c ** (-decay)

        def upd(p, g, vr, vc):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if _is_matrix(p):
                new_vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
                new_vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
                r = new_vr / torch.mean(new_vr, dim=-1, keepdim=True)
                u = g32 / (torch.sqrt(r)[..., None]
                           * torch.sqrt(new_vc)[..., None, :])
            else:
                new_vr = beta2 * vr + (1 - beta2) * g2
                new_vc = vc
                u = g32 / torch.sqrt(new_vr)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            new_p = p - (lr * u + lr * weight_decay * p.float()).to(p.dtype)
            return new_p.to(p.dtype), new_vr, new_vc

        out = [upd(*leaves) for leaves in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.vr),
            tree_leaves(state.vc))]
        new_p, new_vr, new_vc = (tree_unflatten(params, [o[i] for o in out])
                                 for i in range(3))
        return new_p, AdafactorState(new_vr, new_vc, count)

    return Optimizer(init, update, "adafactor")


def get_optimizer(name: str, lr: float, weight_decay: float = 0.0, **kw
                  ) -> Optimizer:
    if name == "sgd":
        return sgd(lr, weight_decay)
    if name == "momentum":
        return momentum(lr, weight_decay=weight_decay, **kw)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay, **kw)
    if name == "adafactor":
        return adafactor(lr, weight_decay=weight_decay, **kw)
    raise ValueError(f"unknown optimizer {name!r}")

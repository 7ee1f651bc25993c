"""Shared set-up of the launch layer's train-program parity tests.

``build_program(cfg, "train_4k", ...)`` of both packages at smoke size,
the reference's on a one-device mesh of ``Auto`` axes (its
``launch.train`` builds a mesh of JAX's default ``Explicit`` axes, on
which its embedding gather raises), both starting from the reference's
weights (carried across by ``convert``) at sigma = 0.  ``run_pair`` feeds
both the same two 4 x 16 batches — fewer than the shape's 256, which
stays the 1/||B^t|| divisor — and holds the parameters after each step
within 1e-5 (atol) and the losses at rtol 1e-5.  SmolLM updates with
momentum instead of its AdamW: Adam's first steps are about
lr * sign(g), which turns a float32 ulp of a near-zero gradient into a
change of lr.  Qwen3 keeps its Adafactor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import get_optimizer as jax_optimizer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch import steps
from repro_torch.optim import get_optimizer

ATOL = 1e-5
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4
B, S = 4, 16
OPTIMIZER = {"smollm-360m": "momentum", "qwen3-moe-30b-a3b": "adafactor"}


def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def cfgs(arch):
    kw = dict(dp_sigma=0.0, optimizer=OPTIMIZER[arch], lr=0.05)
    return jax_smoke_config(arch).replace(**kw), \
        get_smoke_config(arch).replace(**kw)


def programs(mesh, arch, mode):
    """(reference program, port program, reference params, port params)."""
    jcfg, tcfg = cfgs(arch)
    jprog = jsteps.build_program(jcfg, "train_4k", mesh, dp_mode=mode)
    prog = steps.build_program(tcfg, "train_4k", "cpu", dp_mode=mode)
    jparams = jtf.init(jprog.cfg, jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             prog.cfg, device="cpu")
    return jprog, prog, jparams, params


def run_pair(mesh, arch, mode) -> None:
    jprog, prog, jparams, params = programs(mesh, arch, mode)
    assert prog.meta == jprog.meta
    assert prog.cfg.moe_groups == jprog.cfg.moe_groups == 1
    jcfg, tcfg = jprog.cfg, prog.cfg
    jstate = jax_optimizer(jcfg.optimizer, jcfg.lr).init(jparams)
    state = get_optimizer(tcfg.optimizer, tcfg.lr).init(params)
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    jfn = jax.jit(jprog.fn)
    for _ in range(2):
        batch = {k: rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        with mesh:
            jparams, jstate, jm = jfn(
                jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.zeros((2,), jnp.uint32))
        params, state, m = prog.fn(
            params, state, {k: torch.from_numpy(v) for k, v in batch.items()},
            gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        ours = jax.tree_util.tree_leaves(params_to_numpy(params, tcfg))
        ref = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jparams))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        ours = _state_leaves(state, tcfg)
        ref = [np.asarray(x, np.float64)
               for x in jax.tree_util.tree_leaves(jstate)]
        assert [a.shape for a in ours] == [b.shape for b in ref]
        for a, b in zip(ours, ref):
            assert np.linalg.norm(a - b) <= STATE_RTOL * np.linalg.norm(b)


def _state_leaves(state, tcfg) -> list:
    """An optimizer state's leaves (float64 numpy) in the reference's
    order: each parameter-shaped tree in its layout, then the count."""
    leaves = []
    for part in state if isinstance(state, tuple) else (state,):
        if isinstance(part, dict):
            leaves += jax.tree_util.tree_leaves(params_to_numpy(part, tcfg))
        else:
            leaves.append(part.numpy())
    return [np.asarray(x, np.float64) for x in leaves]

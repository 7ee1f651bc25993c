"""repro_torch.optim against the JAX reference's optimizers, on the CPU.

Five updates of every optimizer on one tree (a matrix, a stacked 3-D
leaf, a vector, a 0-d leaf and a bfloat16 matrix), with the same
gradients, weight decay on and off: float32 parameters and every state
leaf at atol = rtol = 1e-6, bfloat16 parameters within one bfloat16 ulp
(both sides round the same float32 step to bfloat16; an ulp covers a
float32 difference at a rounding boundary).  Then the counterparts of
``tests/test_substrate.py``'s ``test_optimizers_descend`` and
``test_adafactor_state_is_factored``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim

torch.set_num_threads(1)

TOL = 1e-6
STEPS = 5
# (name, lr, keyword arguments) — each optimizer with and without decay
CASES = [("sgd", 0.1, {}), ("sgd", 0.1, {"weight_decay": 0.01}),
         ("momentum", 0.1, {}), ("momentum", 0.1, {"weight_decay": 0.01}),
         ("momentum", 0.1, {"beta": 0.5}),
         ("adamw", 1e-2, {}), ("adamw", 1e-2, {"weight_decay": 0.01}),
         ("adamw", 1e-2, {"b1": 0.8, "b2": 0.99, "eps": 1e-6}),
         ("adafactor", 1e-2, {}), ("adafactor", 1e-2, {"weight_decay": 0.01}),
         ("adafactor", 1e-2, {"clip_threshold": 0.5, "decay": 0.5})]
SHAPES = {"w": (6, 5), "stack": (3, 4, 7), "b": (5,), "s": (), "h": (4, 3)}
BF16 = {"h"}


def _tree(rng, scale):
    return {k: (scale * rng.standard_normal(shape)).astype(np.float32)
            for k, shape in SHAPES.items()}


def _port(tree):
    return {k: torch.from_numpy(np.array(v)).to(
        torch.bfloat16 if k in BF16 else torch.float32)
        for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in tree.items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _close_state(ours, ref) -> None:
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == torch.float32
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=TOL, atol=TOL, err_msg=k)
        else:
            assert int(a) == int(b)


@pytest.mark.parametrize("name,lr,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_updates_match_reference(name, lr, kw):
    rng = np.random.default_rng(0)
    start = _tree(rng, 1.0)
    ours_opt = optim.get_optimizer(name, lr, **kw)
    ref_opt = joptim.get_optimizer(name, lr, **kw)
    p, jp = _port(start), _jax(start)
    s, js = ours_opt.init(p), ref_opt.init(jp)
    for _ in range(STEPS):
        grads = _tree(rng, 0.5)
        p, s = ours_opt.update(_port(grads), s, p)
        jp, js = ref_opt.update(_jax(grads), js, jp)
    for k in SHAPES:
        assert p[k].dtype == (torch.bfloat16 if k in BF16 else torch.float32)
        ours = p[k].float().numpy()
        ref = np.asarray(jp[k].astype(jnp.float32))
        if k in BF16:
            assert np.all(np.abs(ours - ref) <= _bf16_ulp(ref)), k
        else:
            np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                       err_msg=k)
    if name == "momentum":
        _close_state([s], [js])
    elif name != "sgd":
        _close_state(s, js)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adafactor"])
def test_optimizers_descend(name):
    opt = optim.get_optimizer(name, 0.05)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    l0 = float(loss(params))
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), (w,))
        params, state = opt.update({"w": g}, state, params)
    assert float(loss(params)) < l0 * 0.05


def test_adafactor_state_is_factored():
    opt = optim.get_optimizer("adafactor", 0.01)
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros(32),
              "stack": torch.zeros((3, 64, 32))}
    state = opt.init(params)
    assert state.vr["w"].shape == (64,)
    assert state.vc["w"].shape == (32,)
    assert state.vr["b"].shape == (32,)   # vectors keep full second moment
    assert state.vc["b"].shape == ()
    assert state.vr["stack"].shape == (3, 64)   # a leading layers axis
    assert state.vc["stack"].shape == (3, 32)
    assert state.count.dtype == torch.int32 and int(state.count) == 0


def test_state_specs_allocate_nothing():
    """``init`` on meta parameters gives meta moments: the launch layer's
    optimizer-state specs."""
    params = {"w": torch.empty((1 << 20, 1 << 14), dtype=torch.bfloat16,
                               device="meta")}
    for name in ("sgd", "momentum", "adamw", "adafactor"):
        state = optim.get_optimizer(name, 0.01).init(params)
        leaves = jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert all(t.is_meta for t in leaves), name
    mu = optim.adamw(0.01).init(params).mu["w"]
    assert mu.dtype == torch.float32 and mu.shape == (1 << 20, 1 << 14)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.get_optimizer("lion", 0.01)

"""repro_torch ghost norms against the JAX reference, on the CPU.

Inputs are made with numpy from a seed, rounded through the working dtype
so both frameworks see equal values, and held against the JAX oracle
(``ghost_norm_ref``) and the Pallas kernel in interpret mode, on the
ghost-norm shapes of ``tests/test_kernels.py`` with that file's
tolerances (2e-5 float32, 3e-2 bfloat16).  On the CPU the wrapper runs the
blocked plain version, so these tests check the algorithm and the
dispatch; ``chip_smoke.py`` holds the CUDA kernel against the plain version
on the card, and ``tests/test_torch_cuda.py`` does the same under
``pytest -m cuda`` there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ghost_norm.kernel import ghost_norm_pallas
from repro.kernels.ghost_norm.ref import ghost_norm_ref as jax_ghost_norm_ref
from repro_torch.kernels.ghost_norm import ops
from repro_torch.kernels.ghost_norm.ref import ghost_norm_ref

torch.set_num_threads(1)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (b, s, d_in, d_out, block_s, block_t): tests/test_kernels.py's shapes
SHAPES = [
    (2, 64, 32, 16, 32, 32),
    (1, 96, 48, 48, 32, 64),   # padding path in the Pallas kernel
    (3, 128, 64, 8, 128, 128),
    (2, 32, 16, 16, 64, 64),   # blocks larger than seq
]


def _inputs(b, s, din, dout, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = (0.5 * rng.standard_normal((b, s, din))).astype(np.float32)
    g = (0.1 * rng.standard_normal((b, s, dout))).astype(np.float32)
    return tuple(np.array(jnp.asarray(x, _JNP[dtype]).astype(jnp.float32))
                 for x in (a, g))


def _torch(x, dtype):
    return torch.from_numpy(x).to(_TORCH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,din,dout,bs,bt", SHAPES)
def test_plain_matches_reference_and_pallas(b, s, din, dout, bs, bt, dtype):
    a, g = _inputs(b, s, din, dout, dtype)
    ops.reset_launches()
    out = ops.ghost_norm(_torch(a, dtype), _torch(g, dtype))
    assert out.shape == (b,) and out.dtype == torch.float32
    ja, jg = jnp.asarray(a, _JNP[dtype]), jnp.asarray(g, _JNP[dtype])
    ref = np.asarray(jax_ghost_norm_ref(ja, jg))
    pal = np.asarray(ghost_norm_pallas(ja, jg, block_s=bs, block_t=bt,
                                       interpret=True))
    tol = TOL[dtype]
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(out.numpy(), pal, rtol=tol, atol=tol)
    assert ops.launches() == 0                # the CPU path launches nothing


@pytest.mark.parametrize("b,s,din,dout,bs,bt", SHAPES)
def test_oracle_is_opt_in_and_agrees(b, s, din, dout, bs, bt):
    a, g = (_torch(x, "float32") for x in _inputs(b, s, din, dout, "float32"))
    oracle = ops.ghost_norm(a, g, prefer_oracle=True)
    torch.testing.assert_close(oracle, ghost_norm_ref(a, g), rtol=0, atol=0)
    np.testing.assert_allclose(
        oracle.numpy(),
        np.asarray(jax_ghost_norm_ref(jnp.asarray(a.numpy()),
                                      jnp.asarray(g.numpy()))),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ops.ghost_norm(a, g).numpy(), oracle.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_blocked_tiles_ragged_sequences():
    """A block that does not divide S (a shorter last tile) changes nothing."""
    a, g = (_torch(x, "float32") for x in _inputs(2, 100, 12, 7, "float32"))
    ref = ghost_norm_ref(a, g)
    for block in (16, 33, 64, 256):
        np.testing.assert_allclose(ops.ghost_norm_blocked(a, g, block).numpy(),
                                   ref.numpy(), rtol=2e-5, atol=2e-5)


def test_matches_outer_product_norms():
    """Cross-check against literally materialised per-example weight grads."""
    b, s, din, dout = 3, 16, 8, 5
    rng = np.random.default_rng(7)
    a = torch.from_numpy(0.5 * rng.standard_normal((b, s, din))).float()
    g = torch.from_numpy(0.5 * rng.standard_normal((b, s, dout))).float()
    explicit = torch.stack([torch.sum(torch.square(a[i].T @ g[i]))
                            for i in range(b)])
    np.testing.assert_allclose(ops.ghost_norm(a, g).numpy(), explicit.numpy(),
                               rtol=1e-5)


def test_mixed_dtypes_promote_to_float32():
    """After a stepped round the parameters are float32 while the first
    layer's activations stay bfloat16: a and g may differ in dtype."""
    a, g = _inputs(2, 40, 24, 10, "bfloat16")
    out = ops.ghost_norm(_torch(a, "bfloat16"), _torch(g, "float32"))
    np.testing.assert_allclose(
        out.numpy(), ghost_norm_ref(_torch(a, "float32"),
                                    _torch(g, "float32")).numpy(),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["rank", "rows", "dtype", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, g = torch.zeros(2, 8, 4), torch.zeros(2, 8, 3)
    if bad == "rank":
        a = a[0]
    elif bad == "rows":
        g = torch.zeros(2, 7, 3)
    elif bad == "dtype":
        a = a.double()
    elif bad == "empty":
        a, g = torch.zeros(2, 0, 4), torch.zeros(2, 0, 3)
    with pytest.raises((ValueError, TypeError)):
        ops.ghost_norm(a, g)

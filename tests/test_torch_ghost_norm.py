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

The CUDA kernel runs both Grams on tensor cores: bf16 products, and float32
as three TF32 products (3xTF32).  ``ghost_norm_tensor_core_plain`` repeats
that arithmetic in plain PyTorch (TF32 rounding by integer bit operations,
float32 accumulators over the kernel's K-steps), and the tests below show
it inside the limits the kernel is held to — rtol 1e-5 against the plain
version (``tests/test_torch_cuda.py``), rtol 1e-4 (``chip_smoke.py``) and
2e-5 against the JAX oracle — at the training scales, while one TF32
product falls outside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ghost_norm.kernel import ghost_norm_pallas
from repro.kernels.ghost_norm.ref import ghost_norm_ref as jax_ghost_norm_ref
from repro_torch.kernels.ghost_norm import ops
from repro_torch.kernels.ghost_norm.ref import (
    ghost_norm_ref, ghost_norm_tensor_core_plain, tf32_round)

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


# -- the kernel's tensor-core arithmetic ----------------------------------------

# (a dtype, g dtype): every pair the kernel takes
PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float32"), ("float32", "bfloat16")]


def _unit_inputs(b, s, din, dout, dtypes, seed=0):
    """The training scales: activations of unit scale, cotangents scaled so
    each example's norm^2 is about 1; each rounded through its dtype."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, s, din)).astype(np.float32)
    g = (rng.standard_normal((b, s, dout))
         / np.sqrt(s * din * dout)).astype(np.float32)
    return _torch(a, "float32").to(_TORCH[dtypes[0]]), \
        _torch(g, "float32").to(_TORCH[dtypes[1]])


def _within(out, ref, rtol, atol) -> bool:
    return bool(torch.all((out - ref).abs() <= atol + rtol * ref.abs()))


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2**-12, 1.0),                             # below half: down
    (1 + 2**-11, 1 + 2**-10),                      # a tie: away from zero
    (-(1 + 2**-11), -(1 + 2**-10)),
    (1 + 2**-10 + 2**-11, 1 + 2**-9),              # a tie from an odd value
    (1 + 2**-10 + 2**-12, 1 + 2**-10),
    (3.0 * 2**-130, 3.0 * 2**-130),                # subnormal, 2 bits wide
])
def test_tf32_round_is_round_to_nearest_ties_away(x, want):
    out = tf32_round(torch.tensor([x], dtype=torch.float32))
    assert out.item() == want
    assert out.view(torch.int32).item() & 0x1FFF == 0


@pytest.mark.parametrize("dtypes", PAIRS, ids="-".join)
@pytest.mark.parametrize("b,s,din,dout,bs,bt", SHAPES)
def test_tensor_core_arithmetic_meets_the_limits(b, s, din, dout, bs, bt,
                                                 dtypes):
    """bf16 products and 3xTF32 float32 products, added in float32 over the
    K-steps, stay inside every limit the kernel is held to."""
    a, g = _unit_inputs(b, s, din, dout, dtypes)
    out = ghost_norm_tensor_core_plain(a, g)
    plain = ops.ghost_norm_blocked(a, g)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)
    assert _within(out, plain, 1e-4, 1e-6)
    oracle = np.asarray(jax_ghost_norm_ref(jnp.asarray(a.float().numpy()),
                                           jnp.asarray(g.float().numpy())))
    np.testing.assert_allclose(out.numpy(), oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("din,dout", [(8, 8), (8, 16), (16, 16)])
def test_tensor_core_arithmetic_at_one_k_step(din, dout):
    """Widths of exactly one K-step (8 float32, 16 bf16 columns)."""
    for dtypes in PAIRS:
        a, g = _unit_inputs(2, 64, din, dout, dtypes, seed=din + dout)
        torch.testing.assert_close(ghost_norm_tensor_core_plain(a, g),
                                   ops.ghost_norm_blocked(a, g), rtol=1e-5,
                                   atol=1e-5)


def test_one_tf32_product_misses_the_limits():
    """A single TF32 product keeps ~2^-11 of each input: on the test_kernels
    shapes in float32 it falls outside the card's rtol 1e-5 and the JAX
    limit, where 3xTF32 stays inside on every one."""
    missed = []
    for b, s, din, dout, _, _ in SHAPES:
        a, g = _unit_inputs(b, s, din, dout, ("float32", "float32"))
        plain = ops.ghost_norm_blocked(a, g)
        one = ghost_norm_tensor_core_plain(a, g, tf32_terms=1)
        three = ghost_norm_tensor_core_plain(a, g, tf32_terms=3)
        assert _within(three, plain, 1e-5, 1e-5)
        if not _within(one, plain, 1e-5, 1e-5):
            missed.append((b, s, din, dout))
            assert not _within(one, ghost_norm_ref(a, g), 2e-5, 2e-5)
    assert len(missed) >= 2, missed


# split_plan on an H100 (132 SMs) at the training shapes (B=16, S=256):
# (d_in, d_out) -> (bf16 split, float32 split)
H100_SMS = 132
TRAIN_SPLITS = {(960, 960): (1, 2), (960, 320): (1, 2), (960, 2560): (2, 4),
                (2560, 960): (2, 4), (960, 49152): (4, 4)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("din,dout", list(TRAIN_SPLITS))
def test_split_plan_comes_from_shapes(din, dout, dtype):
    """Blocks per tile pair: a power of two, doubled while the grid is
    under BLOCKS_PER_SM blocks per SM and each block keeps MIN_CHUNKS
    chunks of 128 bytes a row; from the shapes and the SM count only."""
    size = _TORCH[dtype].itemsize
    split = ops.split_plan(16, 256, din, dout, size, size, H100_SMS)
    assert split == TRAIN_SPLITS[(din, dout)][dtype == "float32"]
    chunks = -(-din * size // ops.CHUNK_BYTES) + \
        -(-dout * size // ops.CHUNK_BYTES)
    assert split & (split - 1) == 0 and split <= ops.MAX_SPLIT
    assert split == 1 or chunks // split >= ops.MIN_CHUNKS
    assert split == 1 or 160 * split // 2 < ops.BLOCKS_PER_SM * H100_SMS


def test_split_plan_spares_a_full_card():
    """A grid that already fills the card, or rows too short to share, is
    not split."""
    assert ops.split_plan(64, 1024, 960, 2560, 2, 2, H100_SMS) == 1
    assert ops.split_plan(1, 64, 16, 16, 4, 4, H100_SMS) == 1
    assert ops.split_plan(1, 64, 4096, 4096, 4, 4, H100_SMS) == ops.MAX_SPLIT

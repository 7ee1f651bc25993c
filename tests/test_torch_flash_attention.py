"""repro_torch flash attention against the JAX reference, on the CPU.

``attention_plain`` (the CUDA kernel's plain version, and the wrapper's
CPU tier) is held against the JAX oracle ``attention_ref`` and against
``flash_attention_pallas`` in interpret mode (``block_q = block_k = 64``),
on the shapes of ``tests/test_kernels.py`` — MQA, a window, a non-causal
case — and on two cases with L != S.  Inputs are made with numpy from a
seed and rounded through the working dtype, so both frameworks see the
same numbers.  Tolerances are ``tests/test_kernels.py``'s: 3e-5 in
float32, 3e-2 in bfloat16.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the CUDA kernel against ``attention_plain`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_plain

torch.set_num_threads(1)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 3e-5, "bfloat16": 3e-2}

# (b, s, l, h, kv, d, causal, window): tests/test_kernels.py's shapes, then
# keys longer and shorter than the queries (positions carry no offset)
CASES = [
    (1, 128, 128, 4, 2, 32, True, None),
    (2, 128, 128, 4, 4, 64, True, 32),
    (1, 256, 256, 8, 2, 32, False, None),
    (1, 128, 128, 2, 1, 128, True, None),     # MQA
    (2, 64, 192, 6, 2, 64, True, 48),         # L > S
    (1, 192, 64, 4, 1, 32, False, 100),       # L < S: late rows see no key
]


def _inputs(b, s, l, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((b, s, h, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, l, kv, d))).astype(np.float32)
    v = rng.standard_normal((b, l, kv, d)).astype(np.float32)
    return tuple(np.array(jnp.asarray(a, _JNP[dtype]).astype(jnp.float32))
                 for a in (q, k, v))


def _port(arrays, dtype):
    return tuple(torch.from_numpy(a).to(_TORCH[dtype]) for a in arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,l,h,kv,d,causal,window", CASES)
def test_attention_plain_matches_reference(b, s, l, h, kv, d, causal, window,
                                           dtype):
    arrays = _inputs(b, s, l, h, kv, d, dtype)
    out = attention_plain(*_port(arrays, dtype), causal=causal, window=window)
    assert out.dtype == _TORCH[dtype] and out.shape == (b, s, h, d)
    jq, jk, jv = (jnp.asarray(a, _JNP[dtype]) for a in arrays)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True)
    ours = out.float().numpy()
    tol = TOL[dtype]
    # rows that see a key (attention_ref averages v over a row that sees
    # none, the Pallas kernel and the port give 0: see the next test)
    seen = _rows_with_keys(s, l, causal, window)
    np.testing.assert_allclose(ours[:, seen], np.asarray(ref, np.float32)[
        :, seen], atol=tol, rtol=tol)
    np.testing.assert_allclose(ours, np.asarray(pallas, np.float32), atol=tol,
                               rtol=tol)


def _rows_with_keys(s, l, causal, window):
    i, j = np.arange(s)[:, None], np.arange(l)[None, :]
    ok = np.ones((s, l), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    return ok.any(axis=1)


def test_row_without_keys_is_zero():
    """A row whose window holds no key comes out 0, as the Pallas kernel's
    acc / max(l, 1e-30) gives it; the oracle's softmax over all-NEG_INF
    scores averages v there instead (ref.py's documented difference)."""
    arrays = _inputs(1, 192, 64, 4, 1, 32, "float32")
    out = attention_plain(*_port(arrays, "float32"), causal=False, window=100)
    jarrays = [jnp.asarray(a) for a in arrays]
    pallas = flash_attention_pallas(*jarrays, causal=False, window=100,
                                    block_q=64, block_k=64, interpret=True)
    ref = attention_ref(*jarrays, causal=False, window=100)
    # rows i >= 64 + 99 see no key j < 64 with j > i - 100
    assert not _rows_with_keys(192, 64, False, 100)[163:].any()
    assert _rows_with_keys(192, 64, False, 100)[:163].all()
    assert torch.all(out[:, 163:] == 0)
    np.testing.assert_array_equal(np.asarray(pallas)[:, 163:], 0.0)
    mean_v = arrays[2].mean(axis=1)                       # [B, KV, D]
    np.testing.assert_allclose(np.asarray(ref)[:, 163:],
                               np.broadcast_to(mean_v[:, None],
                                               (1, 29, 1, 32)).repeat(4, 2),
                               atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns attention_plain's result and
    counts no launch."""
    q, k, v = _port(_inputs(2, 128, 128, 4, 2, 32, "float32"), "float32")
    before = ops.launches()
    out = ops.flash_attention(q, k, v, causal=True, window=32)
    assert ops.launches() == before
    assert torch.equal(out, attention_plain(q, k, v, causal=True, window=32))


@pytest.mark.parametrize("s,l,block_q,block_k", [
    (200, 200, 128, 128),    # S not a multiple of min(block_q, S)
    (128, 200, 128, 128),    # L not a multiple of min(block_k, L)
    (128, 96, 64, 64),       # L = 96 with 64-key blocks
])
def test_wrapper_refuses_what_the_reference_rejects(s, l, block_q, block_k):
    arrays = _inputs(1, s, l, 2, 1, 32, "float32")
    q, k, v = _port(arrays, "float32")
    with pytest.raises(ValueError, match="block multiple"):
        ops.flash_attention(q, k, v, block_q=block_q, block_k=block_k)
    with pytest.raises(AssertionError, match="block multiple"):
        flash_attention_pallas(*(jnp.asarray(a) for a in arrays),
                               block_q=block_q, block_k=block_k,
                               interpret=True)


def test_wrapper_checks_its_inputs():
    q, k, v = _port(_inputs(1, 64, 64, 3, 2, 32, "float32"), "float32")
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(q, k, v)                  # 3 heads over 2
    q, k, v = _port(_inputs(1, 64, 64, 4, 2, 32, "float32"), "float32")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    # S = 12 with the default 128-row blocks: min(128, 12) = 12 divides it
    q, k, v = _port(_inputs(1, 12, 12, 4, 2, 32, "float32"), "float32")
    assert ops.flash_attention(q, k, v).shape == (1, 12, 4, 32)

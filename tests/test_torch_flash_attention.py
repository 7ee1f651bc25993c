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

The bf16 CUDA kernel runs on tensor cores and carries P into P·V as bf16.
``_tensor_core_arithmetic`` repeats its arithmetic in float32 (64-key
tiles, online softmax in log2 units, P in one or two bf16 terms), and two
tests show why the kernel keeps two terms: with one, rows that see a few
keys miss the card's bf16 limit (atol 1e-3 + rtol 1e-2 against
``attention_plain``); with two, every row meets it.
"""

import math

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


def _tensor_core_arithmetic(q, k, v, causal, window, p_terms):
    """The bf16 kernel's arithmetic on bf16 q, k, v: exact bf16 products
    summed in float32, 64-key tiles, scores in log2 units, masked
    probabilities 0, the normaliser from float32 P, and P rounded into
    ``p_terms`` bf16 terms (hi, then lo = P - hi) before P·V."""
    b, s, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(h // kv, dim=2) for t in (k, v))
    sc = torch.einsum("bshd,blhd->bhsl", qf, kf) * (
        math.log2(math.e) / math.sqrt(d))
    i, j = torch.arange(s)[:, None], torch.arange(l)[None, :]
    ok = torch.ones((s, l), dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    m = torch.full((b, h, s), -1e30)
    den = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for t0 in range(0, l, 64):
        keep = ok[:, t0:t0 + 64]
        st = torch.where(keep, sc[..., t0:t0 + 64], -1e30)
        m_new = torch.maximum(m, st.amax(dim=-1))
        p = torch.where(keep, torch.exp2(st - m_new[..., None]), 0.0)
        alpha = torch.exp2(m - m_new)
        den = alpha * den + p.sum(dim=-1)
        hi = p.bfloat16().float()
        terms = hi if p_terms == 1 else hi + (p - hi).bfloat16().float()
        acc = alpha[..., None] * acc + torch.einsum(
            "bhsl,blhd->bhsd", terms, vf[:, t0:t0 + 64])
        m = m_new
    out = acc / den.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


def _outside_bf16_limit(out, ref) -> int:
    err = (out.float() - ref.float()).abs()
    return int((err > 1e-3 + 1e-2 * ref.float().abs()).sum())


@pytest.mark.parametrize("b,s,l,h,kv,d,causal,window", CASES + [
    (2, 512, 512, 15, 5, 64, True, None),     # SmolLM-360M's heads
    (1, 200, 72, 15, 5, 64, True, 40),        # ragged, rows with no key
])
def test_two_bf16_terms_of_p_meet_the_kernel_limit(b, s, l, h, kv, d,
                                                   causal, window):
    q, k, v = _port(_inputs(b, s, l, h, kv, d, "bfloat16", seed=7),
                    "bfloat16")
    out = _tensor_core_arithmetic(q, k, v, causal, window, p_terms=2)
    assert _outside_bf16_limit(out, attention_plain(
        q, k, v, causal=causal, window=window)) == 0


def test_one_bf16_term_of_p_misses_the_kernel_limit():
    """FlashAttention-2 rounds P to bf16 once.  A row that sees two keys
    then moves by up to 2^-9 of the smaller weight times |v|, more than
    1e-3 where its output is near 0: some outputs of a causal case miss
    the limit that two terms meet."""
    q, k, v = _port(_inputs(2, 512, 512, 15, 5, 64, "bfloat16", seed=7),
                    "bfloat16")
    ref = attention_plain(q, k, v, causal=True)
    assert _outside_bf16_limit(_tensor_core_arithmetic(
        q, k, v, True, None, p_terms=1), ref) > 0
    assert _outside_bf16_limit(_tensor_core_arithmetic(
        q, k, v, True, None, p_terms=2), ref) == 0


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

"""repro_torch decode attention against the JAX reference, on the CPU.

The port takes ``index`` as an int32 [B] vector (one position per row);
the reference takes one scalar.  Each case therefore runs the port once
with rows at differing positions, and holds every row against the JAX
oracle (``decode_attention_ref``) and the Pallas kernel in interpret mode,
each called with that row's scalar index.  The shapes are the decode
shapes of ``tests/test_kernels.py``, each with two rows appended at index
0 and index L-1; tolerances are that file's (3e-5 fp32, 3e-2 bf16).  On
the CPU the wrapper runs the plain version, so these tests check the
algorithm; ``chip_smoke.py`` holds the CUDA kernel against it on the card.

The CUDA kernel splits the cache into chunks and merges their statistics
(flash-decoding).  ``decode_attention_split_plain`` repeats that
arithmetic; the split tests hold it against ``decode_attention_plain`` and
the JAX oracle in float32 at rtol 1e-5 (atol 1e-6 for outputs near 0): the
same sums, grouped by chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_plain, decode_attention_split_plain)

torch.set_num_threads(1)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(b, l, h, kv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((b, 1, h, d))).astype(np.float32)
    k = (0.5 * rng.standard_normal((b, l, kv, d))).astype(np.float32)
    v = rng.standard_normal((b, l, kv, d)).astype(np.float32)
    # round through the working dtype so both frameworks see equal inputs
    q, k, v = (np.array(jnp.asarray(a, _JNP[dtype]).astype(jnp.float32))
               for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,l,h,kv,d,index,window,bk",
    [
        (2, 256, 4, 2, 32, 100, None, 128),
        (1, 512, 8, 8, 64, 511, None, 256),
        (2, 256, 4, 1, 32, 200, 64, 64),      # windowed MQA
        (1, 1024, 4, 4, 128, 0, None, 512),   # first token
    ],
)
def test_decode_attention_rows_match_reference(b, l, h, kv, d, index, window,
                                               bk, dtype):
    rows = [index] * b + [0, l - 1]
    if b > 1:
        rows[1] = index // 2                  # rows of one case differ
    n = len(rows)
    q, k, v = _case(n, l, h, kv, d, dtype)
    tdt = _TORCH[dtype]
    out = ops.decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.tensor(rows, dtype=torch.int32),
        window=window)
    assert out.shape == (n, 1, h, d) and out.dtype == tdt
    out = out.float().numpy()
    tol = 3e-5 if dtype == "float32" else 3e-2
    jq, jk, jv = (jnp.asarray(a, _JNP[dtype]) for a in (q, k, v))
    for idx in sorted(set(rows)):
        ref = np.asarray(decode_attention_ref(jq, jk, jv, idx, window=window),
                         np.float32)
        pal = np.asarray(decode_attention_pallas(
            jq, jk, jv, idx, window=window, block_k=bk, interpret=True),
            np.float32)
        for r in (r for r, x in enumerate(rows) if x == idx):
            np.testing.assert_allclose(out[r], ref[r], atol=tol, rtol=tol)
            np.testing.assert_allclose(out[r], pal[r], atol=tol, rtol=tol)
    assert ops.launches() == 0                # the CPU path launches nothing


def test_cpu_call_leaves_launch_counter_at_zero():
    ops.reset_launches()
    q = torch.zeros(2, 1, 4, 32)
    k = torch.zeros(2, 8, 2, 32)
    ops.decode_attention(q, k, k, torch.tensor([0, 7], dtype=torch.int32))
    assert ops.launches() == 0


@pytest.mark.parametrize("bad", ["q_rank", "heads", "dtype", "index_dtype",
                                 "index_shape", "window", "mixed_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 1, 4, 32)
    k = torch.zeros(2, 8, 2, 32)
    idx = torch.tensor([0, 7], dtype=torch.int32)
    kw = {}
    if bad == "q_rank":
        q = q[:, 0]
    elif bad == "heads":
        q = torch.zeros(2, 1, 3, 32)
    elif bad == "dtype":
        q, k = q.double(), k.double()
    elif bad == "index_dtype":
        idx = idx.long()
    elif bad == "index_shape":
        idx = idx[:1]
    elif bad == "window":
        kw["window"] = 0
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(q, k, k, idx, **kw)


H100_SMS = 132   # SMs of an H100 SXM, the card the plans are sized for

# (rows, l, h, kv, d, window, chunk): one below, at and one above a chunk
# boundary with L not a multiple of the chunk; chunks wholly past the index;
# windows across two chunks; the serving shape at the wrapper's own plan
SPLIT_CASES = [
    ([0, 63, 64, 65, 127, 128, 199], 200, 4, 2, 32, None, 64),
    ([0, 0, 5, 40], 256, 4, 1, 32, None, 64),
    ([100, 64, 127, 128, 255], 256, 8, 2, 64, 64, 64),
    ([37, 90, 150], 300, 6, 3, 32, 70, 32),
    ([0, 1, 63, 64, 200, 400, 510, 511], 512, 15, 5, 64, None,
     ops.split_plan(8, 512, 5, H100_SMS)[1]),
    ([3, 700, 1000, 1023], 1024, 8, 1, 128, 300,
     ops.split_plan(4, 1024, 1, H100_SMS)[1]),
]


@pytest.mark.parametrize("rows,l,h,kv,d,window,chunk", SPLIT_CASES)
def test_split_and_combine_matches_plain_and_reference(rows, l, h, kv, d,
                                                       window, chunk):
    q, k, v = _case(len(rows), l, h, kv, d, "float32", seed=len(rows) + l)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    idx = torch.tensor(rows, dtype=torch.int32)
    out = decode_attention_split_plain(tq, tk, tv, idx, chunk=chunk,
                                       window=window)
    plain = decode_attention_plain(tq, tk, tv, idx, window=window)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for r, i in enumerate(rows):
        ref = np.asarray(decode_attention_ref(jq, jk, jv, i, window=window))
        np.testing.assert_allclose(out[r].numpy(), ref[r], rtol=1e-5,
                                   atol=1e-6)


def test_split_and_combine_in_one_chunk_is_one_pass():
    """A chunk as long as the cache is the single-pass softmax: the
    combine's weight e^(m - M) is 1."""
    q, k, v = (torch.from_numpy(a) for a in _case(3, 96, 4, 2, 32, "float32"))
    idx = torch.tensor([0, 50, 95], dtype=torch.int32)
    one = decode_attention_split_plain(q, k, v, idx, chunk=96, window=20)
    np.testing.assert_allclose(one.numpy(), decode_attention_plain(
        q, k, v, idx, window=20).numpy(), rtol=1e-6, atol=1e-7)


def test_rows_attending_nothing_come_out_zero():
    """An index past the cache with a window that ends before it leaves
    every chunk empty; the kernel's combine gives 0 there."""
    q, k, v = (torch.from_numpy(a) for a in _case(2, 128, 4, 2, 32, "float32"))
    idx = torch.tensor([300, 10], dtype=torch.int32)
    out = decode_attention_split_plain(q, k, v, idx, chunk=64, window=8)
    assert torch.all(out[0] == 0) and torch.all(out[1] != 0)


@pytest.mark.parametrize("b,l,kv", [(8, 512, 5), (8, 4096, 5), (1, 8, 1),
                                    (2, 256, 2), (64, 512, 5), (1, 1000, 1)])
def test_split_plan_comes_from_shapes(b, l, kv):
    n, chunk = ops.split_plan(b, l, kv, H100_SMS)
    assert chunk % ops.SPLIT_ROWS == 0 and (n - 1) * chunk < l <= n * chunk
    # at least 2 blocks per SM of an H100 where the cache has the rows
    assert b * kv * n >= min(2 * H100_SMS, b * kv * -(-l // ops.SPLIT_ROWS))
    if (b, l, kv) == (8, 512, 5):                 # the serving shape
        assert (n, chunk) == (8, 64)              # 320 blocks on 132 SMs

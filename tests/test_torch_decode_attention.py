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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import ops

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

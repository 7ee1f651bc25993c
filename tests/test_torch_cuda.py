"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc`` (the kernels build at first
use); elsewhere they skip.  They import no JAX, so they run on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: ``decode_attention`` at ``tests/test_kernels.py``'s (3e-5
float32, 3e-2 bfloat16) against its plain version on the same inputs;
``ghost_norm`` at rtol 1e-5, with a and g in one dtype or in two (as a
training round meets them) — the kernel and the plain version both sum in
float32 over the same inputs, in other orders.
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.ghost_norm import ops as ghost_ops

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (a dtype, g dtype): the same in both, and the mixed pairs a training round
# meets once float32 gradients have promoted the parameters
GHOST_DTYPES = [pytest.param(("float32", "float32"), id="float32"),
                pytest.param(("bfloat16", "bfloat16"), id="bfloat16"),
                pytest.param(("bfloat16", "float32"), id="bfloat16-float32"),
                pytest.param(("float32", "bfloat16"), id="float32-bfloat16")]


@pytest.mark.parametrize("dtype", GHOST_DTYPES)
@pytest.mark.parametrize("b,s,din,dout", [(2, 64, 32, 16), (1, 96, 48, 48),
                                          (3, 128, 64, 8), (2, 32, 16, 16),
                                          (4, 300, 100, 70),
                                          (16, 256, 960, 960),
                                          (16, 256, 960, 320)])
def test_ghost_norm_kernel_matches_plain(dev, b, s, din, dout, dtype):
    g_ = torch.Generator(device=dev).manual_seed(b * s + din)
    a = (0.5 * torch.randn((b, s, din), generator=g_, device=dev)).to(
        DTYPES[dtype[0]])
    g = (0.1 * torch.randn((b, s, dout), generator=g_, device=dev)).to(
        DTYPES[dtype[1]])
    before = ghost_ops.launches()
    out = ghost_ops.ghost_norm(a, g)
    assert ghost_ops.launches() == before + 1
    torch.testing.assert_close(out, ghost_ops.ghost_norm_blocked(a, g),
                               rtol=1e-5, atol=1e-5)
    # the same inputs give the same norms, bit for bit (no atomics)
    assert torch.equal(out, ghost_ops.ghost_norm(a, g))


def test_ghost_norm_kernel_refuses_non_contiguous_inputs(dev):
    a = torch.zeros((2, 8, 4), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ghost_ops.ghost_norm(a, torch.zeros((2, 4, 3), device=dev))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,h,kv,d,window", [(2, 256, 4, 2, 32, None),
                                               (1, 512, 8, 8, 64, None),
                                               (2, 256, 4, 1, 32, 64),
                                               (1, 1024, 4, 4, 128, None)])
def test_decode_attention_kernel_matches_plain(dev, b, l, h, kv, d, window,
                                               dtype):
    g_ = torch.Generator(device=dev).manual_seed(l + d)
    rows = [l // 3] * b + [0, l - 1]
    n = len(rows)
    q = (0.5 * torch.randn((n, 1, h, d), generator=g_, device=dev)).to(
        DTYPES[dtype])
    k = (0.5 * torch.randn((n, l, kv, d), generator=g_, device=dev)).to(
        DTYPES[dtype])
    v = torch.randn((n, l, kv, d), generator=g_, device=dev).to(DTYPES[dtype])
    index = torch.tensor(rows, dtype=torch.int32, device=dev)
    out = decode_ops.decode_attention(q, k, v, index, window=window)
    tol = 3e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(out.float(), decode_attention_plain(
        q, k, v, index, window=window).float(), rtol=tol, atol=tol)

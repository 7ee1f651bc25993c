"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc`` (the kernels build at first
use); elsewhere they skip.  They import no JAX, so they run on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: ``decode_attention`` and ``flash_attention`` at 3e-5 in
float32 and at atol 1e-3 + rtol 1e-2 in bfloat16 against their plain
versions on the same inputs (both sides accumulate in float32 from the
same inputs, the bf16 flash kernel on tensor cores with P in two bf16
terms, and differ by the output's rounding, a few ulps;
``tests/test_kernels.py``'s 3e-2 is as large as a long row's typical
output);
``ghost_norm`` at rtol 1e-5, with a and g in one dtype or in two (as a
training round meets them) — the kernel (bf16 products, float32 ones as
3xTF32 on the tensor cores) and the plain version both sum in float32
over the same inputs, in other orders.
"""

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.ghost_norm import ops as ghost_ops
from repro_torch.models import transformer as tf
from repro_torch.serve.federation import transformer_model

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


def _ghost_inputs(dev, b, s, din, dout, dtype, offset=0):
    """a and g at tests/test_kernels.py's scales, each starting ``offset``
    elements into its buffer."""
    g_ = torch.Generator(device=dev).manual_seed(b * s + din)
    out = []
    for shape, scale, dt in (((b, s, din), 0.5, dtype[0]),
                             ((b, s, dout), 0.1, dtype[1])):
        x = (scale * torch.randn(shape, generator=g_, device=dev)).to(
            DTYPES[dt])
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        out.append(buf[offset:].view(shape).copy_(x))
    return out


# the test_kernels.py shapes, ragged S, widths of one 32-byte K-step (16
# bf16, 8 float32 columns) and rows that are not 16-byte multiples (100,
# 70 and 33 columns), then SmolLM-360M's training shapes (q/o, k/v, up/gate
# and down projections)
@pytest.mark.parametrize("dtype", GHOST_DTYPES)
@pytest.mark.parametrize("b,s,din,dout", [(2, 64, 32, 16), (1, 96, 48, 48),
                                          (3, 128, 64, 8), (2, 32, 16, 16),
                                          (4, 300, 100, 70),
                                          (2, 100, 33, 37), (2, 64, 8, 16),
                                          (16, 256, 960, 960),
                                          (16, 256, 960, 320),
                                          (16, 256, 960, 2560),
                                          (16, 256, 2560, 960)])
def test_ghost_norm_kernel_matches_plain(dev, b, s, din, dout, dtype):
    a, g = _ghost_inputs(dev, b, s, din, dout, dtype)
    before = ghost_ops.launches()
    out = ghost_ops.ghost_norm(a, g)
    assert ghost_ops.launches() == before + 1
    torch.testing.assert_close(out, ghost_ops.ghost_norm_blocked(a, g),
                               rtol=1e-5, atol=1e-5)
    # the same inputs give the same norms, bit for bit (no atomics)
    assert torch.equal(out, ghost_ops.ghost_norm(a, g))


@pytest.mark.parametrize("dtype", GHOST_DTYPES)
@pytest.mark.parametrize("b,s,din,dout", [(1, 64, 4096, 4096),
                                          (2, 130, 960, 2560),
                                          (1, 200, 3000, 777)])
def test_ghost_norm_kernel_split_matches_plain(dev, b, s, din, dout, dtype):
    """Few tile pairs over wide rows: several blocks share each pair's
    chunks, and a third kernel adds their Grams in a fixed order."""
    a, g = _ghost_inputs(dev, b, s, din, dout, dtype)
    assert ghost_ops.split_plan(b, s, din, dout, a.element_size(),
                                g.element_size(),
                                ghost_ops.sm_count(dev)) > 1
    out = ghost_ops.ghost_norm(a, g)
    torch.testing.assert_close(out, ghost_ops.ghost_norm_blocked(a, g),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, ghost_ops.ghost_norm(a, g))


@pytest.mark.parametrize("dtype", GHOST_DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ghost_norm_kernel_at_unaligned_addresses(dev, offset, dtype):
    """a and g that start off a 16-byte address (a non-zero storage offset)
    take the kernel's narrower copies, with the same results."""
    a, g = _ghost_inputs(dev, 2, 128, 64, 48, dtype, offset=offset)
    assert a.storage_offset() == g.storage_offset() == offset
    out = ghost_ops.ghost_norm(a, g)
    torch.testing.assert_close(out, ghost_ops.ghost_norm_blocked(a, g),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out, ghost_ops.ghost_norm(a, g))


def test_ghost_norm_kernel_fills_the_card(dev):
    """As many tile blocks stay resident per SM as the kernel is built for:
    3 with both operands in bf16, 4 with a float32 one (so S = 256's 160
    tile pairs of B = 16 run in one wave on 132 SMs, split or not)."""
    for a_dt, g_dt in (p.values[0] for p in GHOST_DTYPES):
        want = 3 if a_dt == g_dt == "bfloat16" else 4
        assert ghost_ops.blocks_per_sm(DTYPES[a_dt], DTYPES[g_dt]) >= want


def test_ghost_norm_kernel_refuses_non_contiguous_inputs(dev):
    a = torch.zeros((2, 8, 4), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ghost_ops.ghost_norm(a, torch.zeros((2, 4, 3), device=dev))


# decode kernel against its plain version.  bfloat16: both sides
# accumulate in float32 from the same bf16 inputs and differ by the
# output's rounding (<= 1 ulp), as in flash's limit; an absolute 3e-2 is
# as large as the typical output of a long cache and would pass a wrong tile
DECODE_TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
              "bfloat16": dict(atol=1e-3, rtol=1e-2)}


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
    torch.testing.assert_close(out.float(), decode_attention_plain(
        q, k, v, index, window=window).float(), **DECODE_TOL[dtype])


def _split_rows(kind, l, c):
    """(rows, window) of one edge case, with c the kernel's chunk."""
    if kind == "index0":
        return [0] * 8, None
    if kind == "boundaries":
        return [c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1, l - 2,
                l - 1], None
    if kind == "window-across-splits":
        return [c + c // 2] * 4 + [c + 1] * 4, c
    return [0, 1, c, l // 2, l - c - 1, l - 3, l - 2, l - 1], None


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,h,kv,d,kind", [
    pytest.param(l, h, kv, d, kind, id=f"L{l}-{kind}")
    for l, h, kv, d in [(512, 15, 5, 64), (1000, 8, 1, 128), (300, 4, 2, 32)]
    for kind in ("index0", "boundaries", "window-across-splits",
                 "rows-far-apart")])
def test_decode_attention_split_edges_match_plain(dev, l, h, kv, d, kind,
                                                  dtype):
    """Around the chunks that ``split_plan`` gives 8 rows of the case's
    cache on this card (L = 1000 and 300 are not multiples of theirs): the
    plain version's values, one counted launch per call, and a second call
    bit for bit (the combine has a fixed order)."""
    c = decode_ops.split_plan(8, l, kv, decode_ops.sm_count(dev))[1]
    rows, window = _split_rows(kind, l, c)
    g_ = torch.Generator(device=dev).manual_seed(l + d + len(set(rows)))
    n = len(rows)
    q = (0.5 * torch.randn((n, 1, h, d), generator=g_, device=dev)).to(
        DTYPES[dtype])
    k = (0.5 * torch.randn((n, l, kv, d), generator=g_, device=dev)).to(
        DTYPES[dtype])
    v = torch.randn((n, l, kv, d), generator=g_, device=dev).to(DTYPES[dtype])
    index = torch.tensor(rows, dtype=torch.int32, device=dev)
    before = decode_ops.launches()
    out = decode_ops.decode_attention(q, k, v, index, window=window)
    assert decode_ops.launches() == before + 1
    torch.testing.assert_close(out.float(), decode_attention_plain(
        q, k, v, index, window=window).float(), **DECODE_TOL[dtype])
    assert torch.equal(out, decode_ops.decode_attention(q, k, v, index,
                                                        window=window))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,l,h,kv,d,causal,window", [
    (1, 128, 128, 4, 2, 32, True, None),
    (2, 128, 128, 4, 4, 64, True, 32),
    (1, 256, 256, 8, 2, 32, False, None),
    (1, 128, 128, 2, 1, 128, True, None),      # MQA
    (2, 64, 192, 6, 2, 64, True, 48),          # L > S
    (1, 192, 64, 4, 1, 32, False, 100),        # L < S: rows with no key
    (2, 100, 100, 15, 5, 64, True, None),      # ragged tiles, SmolLM heads
    (1, 64, 64, 16, 1, 64, True, None),        # group 16: split over blocks
    (2, 96, 96, 15, 5, 64, True, None),        # S = L = 96: ragged tiles
    (1, 200, 200, 15, 5, 64, True, None),      # S = L = 200
    (1, 200, 200, 15, 5, 64, True, 1),         # window 1: the diagonal
    (2, 256, 256, 4, 4, 64, True, 64),         # window = the key tile
    (1, 320, 320, 8, 2, 64, True, 150),        # window over three tiles
    (1, 128, 128, 5, 1, 32, True, None),       # group 5
    (1, 128, 320, 8, 2, 64, True, 100),        # L > S with a window
    (1, 200, 72, 15, 5, 64, True, 40),         # L < S: rows with no key
    (1, 96, 160, 4, 1, 64, False, 50),         # non-causal window, ragged
    (1, 200, 200, 4, 2, 32, True, 70),         # D = 32
    (2, 200, 200, 8, 2, 128, True, None),      # D = 128
])
def test_flash_attention_kernel_matches_plain(dev, b, s, l, h, kv, d, causal,
                                              window, dtype):
    g_ = torch.Generator(device=dev).manual_seed(s + l + d)
    q = (0.5 * torch.randn((b, s, h, d), generator=g_, device=dev)).to(
        DTYPES[dtype])
    k = (0.5 * torch.randn((b, l, kv, d), generator=g_, device=dev)).to(
        DTYPES[dtype])
    v = torch.randn((b, l, kv, d), generator=g_, device=dev).to(DTYPES[dtype])
    variant = flash_ops.VARIANTS[DTYPES[dtype]]
    before = flash_ops.launches(variant)
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    block_q=s, block_k=l)
    assert flash_ops.launches(variant) == before + 1
    atol, rtol = (3e-5, 3e-5) if dtype == "float32" else (1e-3, 1e-2)
    torch.testing.assert_close(out.float(), attention_plain(
        q, k, v, causal=causal, window=window).float(), rtol=rtol, atol=atol)
    # the same inputs give the same output, bit for bit (no atomics)
    assert torch.equal(out, flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, block_q=s, block_k=l))


def test_flash_attention_kernel_refuses_to_be_differentiated(dev):
    q, k, v = (torch.randn((1, 64, 2, 32), device=dev) for _ in range(3))
    q.requires_grad_()
    before = flash_ops.launches()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.launches() == before
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.launches() == before + 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_use_flash_forward_launches_once_per_layer(dev, dtype):
    """SmolLM-360M at full width: one kernel launch per layer (32) per
    forward, all of the dtype's kernel; in float32, the logits of the
    model's plain attention within 1e-3 (the whole-path tolerance of
    ``chip_smoke.py``)."""
    cfg = get_config("smollm-360m").replace(
        use_flash=True, param_dtype=dtype, compute_dtype=dtype)
    params = tf.init(cfg, 0, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    flash_ops.reset_launches()
    with torch.no_grad():
        logits, _ = tf.forward(cfg, params, {"tokens": tokens})
    assert flash_ops.launches() == cfg.n_layers == 32
    # bf16 through the tensor-core kernel, float32 through the CUDA-core one
    assert flash_ops.launches(flash_ops.VARIANTS[DTYPES[dtype]]) == 32
    assert logits.dtype == DTYPES[dtype]
    assert bool(torch.isfinite(logits).all())
    if dtype == "float32":
        with torch.no_grad():
            plain, _ = tf.forward(cfg.replace(use_flash=False), params,
                                  {"tokens": tokens})
        torch.testing.assert_close(logits, plain, rtol=0, atol=1e-3)


def test_predict_fn_runs_the_kernel_with_grad_mode_on(dev):
    """``predict_fn`` is an argmax that nothing differentiates: it runs the
    kernel even where grad mode is on and the parameters require grad."""
    cfg = get_smoke_config("smollm-360m").replace(use_flash=True,
                                                  tie_embeddings=False)
    params = tf.init(cfg, 0, dev)
    for t in [params["embed"], params["final_norm"], params["head"],
              *params["layers"].values()]:
        t.requires_grad_()
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    flash_ops.reset_launches()
    assert torch.is_grad_enabled()
    pred = transformer_model(cfg, device=str(dev)).predict_fn(params, tokens)
    assert flash_ops.launches() == cfg.n_layers
    with torch.no_grad():
        logits, _ = tf.forward(cfg, params, {"tokens": tokens})
    assert torch.equal(pred, torch.argmax(logits[:, -1], dim=-1))

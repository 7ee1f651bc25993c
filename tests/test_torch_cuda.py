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

import numpy as np
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
from repro_torch.tree import tree_leaves

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
@pytest.mark.parametrize("split", ["columns", "rows"])
def test_ghost_norm_on_split_shards_sums_to_the_whole(dev, split, dtype):
    """The shard backend's model axis: the kernel on each rank's column
    block of g (or row block of A^T, a's columns), summed over the
    blocks, is the kernel on the whole (||A^T G||^2 splits by blocks)."""
    a, g = _ghost_inputs(dev, 16, 256, 960, 2560, dtype)
    whole = ghost_ops.ghost_norm(a, g)
    parts = (torch.chunk(g, 2, dim=2) if split == "columns"
             else torch.chunk(a, 2, dim=2))
    total = sum(ghost_ops.ghost_norm(a, p.contiguous()) if split == "columns"
                else ghost_ops.ghost_norm(p.contiguous(), g) for p in parts)
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(total, ghost_ops.ghost_norm_blocked(a, g),
                               rtol=1e-5, atol=1e-5)


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
    # head dims 192 (Nemotron-4-340B) and 256 (Gemma-7B): Q staged in
    # shared memory and 32-key tiles in bf16, 8 lanes a row and 32-row
    # blocks in float32
    (2, 128, 128, 16, 16, 256, True, None),    # Gemma's heads
    (1, 160, 160, 24, 2, 192, True, None),     # group 12, ragged tiles
    (1, 200, 200, 8, 1, 256, True, 40),        # MQA, a window
    (1, 130, 130, 6, 2, 192, True, 1),         # window 1: the diagonal
    (1, 96, 160, 4, 1, 256, False, 50),        # non-causal window, L > S
    (1, 200, 72, 6, 2, 192, True, 40),         # L < S: rows with no key
    (2, 33, 33, 4, 4, 256, True, None),        # one ragged tile
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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch,h,kv,d", [("gemma-7b", 16, 16, 256),
                                        ("nemotron-4-340b", 96, 8, 192)])
def test_use_flash_at_the_zoo_head_dims(dev, arch, h, kv, d, dtype):
    """``use_flash`` at Gemma-7B's and Nemotron-4-340B's attention heads
    (their smoke configs at the full configs' heads, 2 layers): one launch
    of the dtype's kernel per layer, each layer's kernel output within
    the kernel tolerance of ``attention_plain`` on its own q, k, v, and
    in float32 the logits of the model's plain ``_sdpa`` within 1e-4."""
    from unittest import mock

    from repro_torch.models import attention as attn_lib

    cfg = get_smoke_config(arch).replace(
        n_heads=h, n_kv_heads=kv, head_dim=d, use_flash=True,
        param_dtype=dtype, compute_dtype=dtype)
    params = tf.init(cfg, 0, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    seen, kernel = [], attn_lib.flash_attention

    def capture(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    flash_ops.reset_launches()
    with mock.patch.object(attn_lib, "flash_attention", capture), \
            torch.no_grad():
        logits, _ = tf.forward(cfg, params, {"tokens": tokens})
    assert flash_ops.launches(flash_ops.VARIANTS[DTYPES[dtype]]) == \
        cfg.n_layers == len(seen)
    atol, rtol = (3e-5, 3e-5) if dtype == "float32" else (1e-3, 1e-2)
    for q, k, v, kw, out in seen:
        torch.testing.assert_close(out.float(), attention_plain(
            q, k, v, causal=kw["causal"], window=kw["window"]).float(),
            rtol=rtol, atol=atol)
    assert bool(torch.isfinite(logits).all())
    if dtype == "float32":
        with torch.no_grad():
            plain, _ = tf.forward(cfg.replace(use_flash=False), params,
                                  {"tokens": tokens})
        torch.testing.assert_close(logits, plain, rtol=0, atol=1e-4)


def test_jamba_decode_step_on_the_card_matches_the_cpu(dev):
    """Jamba's smoke stack (Mamba-1 + attention through the decode kernel,
    MoE) in float32: a prefill and a ragged per-row decode step on the card
    against the same on the CPU, logits and every cache leaf at 1e-4; the
    step again bit for bit, and under ``set_sync_debug_mode("error")``."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("jamba-v0.1-52b").replace(use_decode_kernel=True)
    params = tf.init(cfg, 0, "cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    prompt = torch.randint(0, cfg.vocab_size, (3, 5),
                           generator=torch.Generator().manual_seed(2))
    tokens = torch.randint(0, cfg.vocab_size, (3, 1),
                           generator=torch.Generator().manual_seed(3))
    positions = torch.tensor([5, 2, 9], dtype=torch.int32)
    out = {}
    for where, p in (("cpu", params), ("cuda", on_card)):
        cache = tf.init_cache(cfg, 3, 12, where)
        first, cache = tf.prefill(cfg, p, cache, prompt.to(where))
        before = decode_ops.launches()
        logits, cache = tf.decode_step_positions(
            cfg, p, cache, tokens.to(where), positions.to(where))
        if where == "cuda":
            assert decode_ops.launches() == before + 1   # one attention layer
        out[where] = {"prefill": first, "step": logits, "cache": cache}
    for a, b in zip(tree_leaves(out["cpu"]), tree_leaves(out["cuda"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)
    cache = out["cuda"]["cache"]
    snapshot = tree_map(torch.clone, cache)
    tokens, positions = tokens.to(dev), positions.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, _ = tf.decode_step_positions(cfg, on_card, snapshot, tokens,
                                            positions)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    twice, _ = tf.decode_step_positions(cfg, on_card, tree_map(
        torch.clone, cache), tokens, positions)
    assert torch.equal(again, twice)


def test_rwkv6_steps_repeat_bit_for_bit_without_host_sync(dev):
    """RWKV6's decode step (no attention, so no decode kernel launch) in
    bf16 twice from one state, bit for bit, and under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("rwkv6-3b").replace(
        use_decode_kernel=True, param_dtype="bfloat16",
        compute_dtype="bfloat16")
    params = tf.init(cfg, 0, dev)
    cache = tf.init_cache(cfg, 4, 16, dev)
    tf.prefill(cfg, params, cache, torch.arange(1, 13, device=dev).reshape(
        4, 3))
    tokens = torch.tensor([[3], [7], [3], [100]], dtype=torch.int32,
                          device=dev)
    positions = torch.tensor([3, 3, 3, 3], dtype=torch.int32, device=dev)
    runs = []
    before = decode_ops.launches()
    for _ in range(2):
        c = tree_map(torch.clone, cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runs.append(tf.decode_step_positions(cfg, params, c, tokens,
                                                 positions))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert decode_ops.launches() == before
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                                 tree_leaves(runs[1][1])))


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


def test_population_at_q1_is_ideal_bit_for_bit_through_ghost_norm(dev):
    """A decaph round through the ghost path is bit-reproducible on the
    card (the embedding's gradient is summed in sorted order, not by
    atomics), so ``population`` at q = 1 is ``ideal`` bit for bit, with
    the same ``ghost_norm`` launches (29 per participant and round)."""
    import repro_torch.arms as arms
    import repro_torch.scenarios as sc
    from repro_torch.sim import Topology
    from repro_torch.tree import tree_leaves

    spec = sc.get_preset("lm-full").replace(backend="ideal", rounds=2,
                                            noise_multiplier=0.0)
    model, silos, cfg, _, _ = sc.build_scenario(spec, device=str(dev))
    runs = []
    for backend, kw in (("ideal", {}), ("ideal", {}),
                        ("population", {"topo": Topology.full(4)})):
        ghost_ops.reset_launches()
        rep = arms.run("decaph", model, silos, cfg, backend=backend, **kw)
        runs.append((tree_leaves(rep.params), ghost_ops.launches()))
    for leaves, launches in runs[1:]:
        assert launches == runs[0][1] == 29 * 4 * 2
        assert all(torch.equal(a, b) for a, b in zip(runs[0][0], leaves))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decaph_round_on_real_rows_matches_the_padded_round(dev, dtype,
                                                            monkeypatch):
    """One fused DeCaPH round at sigma 0 of SmolLM-360M's width at 2
    layers, untied, on 4 hospitals' draws of about 2 notes of 128 tokens
    (pad 8): each slot clipped on its real rows only, against the same
    round with every count forced to the pad.  The ghost passes' GEMMs and
    ``ghost_norm`` then run at 1-8 rows instead of 8; the parameters agree
    within 1e-5."""
    import dataclasses

    import repro_torch.arms as arms
    import repro_torch.obs as obs
    from repro_torch.arms import fused
    from repro_torch.configs.base import dense_stack
    from repro_torch.core.dp import DPConfig
    from repro_torch.serve.federation import token_silos

    cfg = get_config("smollm-360m").replace(
        n_layers=2, stack=dense_stack(2), tie_embeddings=False,
        param_dtype=dtype, compute_dtype=dtype)
    model = transformer_model(cfg, device=dev)
    silos = token_silos(cfg, hospitals=4, n_per=64, seq_len=128, seed=3)
    run_cfg = arms.ArmConfig(rounds=1, batch_size=8, lr=0.05,
                             use_secagg=False, clipping="ghost",
                             dp=DPConfig(clip_norm=1.0, noise_multiplier=0.0))
    stack_poisson = fused.stack_poisson

    pads = []

    def padded(*args, **kw):
        cb = stack_poisson(*args, **kw)
        pads.append(cb.masks.shape[-1])
        return dataclasses.replace(cb, counts=np.full_like(cb.counts,
                                                           pads[-1]))

    out = {}
    for mode in ("real", "padded"):
        if mode == "padded":
            monkeypatch.setattr(fused, "stack_poisson", padded)
        with obs.recording() as rec:
            rep = arms.run("decaph", model, silos, run_cfg)
        out[mode] = (rep, rec.counter_totals())
    (real, real_rows), (pad, pad_rows) = out["real"], out["padded"]
    assert real.logs[0].aggregate_batch == pad.logs[0].aggregate_batch > 0
    assert real_rows["rows.computed"] == real_rows["rows.real"]
    assert pad_rows["rows.computed"] == 4 * pads[0]
    for a, b in zip(tree_leaves(real.params), tree_leaves(pad.params)):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= 1e-5
    assert abs(real.logs[0].loss - pad.logs[0].loss) <= 1e-5


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,h,kv,d,window", [
    (8, 512, 16, 16, 256, None),     # Gemma-7B's heads
    (8, 512, 96, 8, 192, None),      # Nemotron-4-340B's: group 12
    (2, 300, 16, 16, 256, 64),
    (3, 1000, 24, 2, 192, None)])
def test_decode_attention_kernel_at_the_zoo_head_dims(dev, b, l, h, kv, d,
                                                      window, dtype):
    """Head dims 192 and 256 (D = 256 takes more than 48 KB of dynamic
    shared memory): the plain version's values, at rows 0 and L-1 too and
    around the split plan's chunk edges, and a second launch bit for bit."""
    c = decode_ops.split_plan(b + 2, l, kv, decode_ops.sm_count(dev))[1]
    rows = [min(c * (i + 1) - i % 2, l - 1) for i in range(b)] + [0, l - 1]
    g_ = torch.Generator(device=dev).manual_seed(l + d)
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
    assert torch.equal(out, decode_ops.decode_attention(q, k, v, index,
                                                        window=window))


def test_moe_decode_steps_repeat_bit_for_bit(dev):
    """Qwen3-30B-A3B's MoE decode step (a row per dispatch group) and its
    one-group step repeat bit for bit: the combine sums each token's
    choices in a fixed order, with no atomics."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b").replace(
        use_decode_kernel=True, param_dtype="bfloat16",
        compute_dtype="bfloat16")
    params = tf.init(cfg, 0, dev)
    cache = tf.init_cache(cfg, 4, 32, dev)
    tokens = torch.tensor([[3], [7], [3], [100]], dtype=torch.int32,
                          device=dev)
    positions = torch.tensor([0, 5, 17, 31], dtype=torch.int32, device=dev)
    for step in (lambda: tf.decode_step_positions(cfg, params, cache, tokens,
                                                  positions),
                 lambda: tf.decode_step(cfg, params, cache, tokens, 9)):
        assert torch.equal(step()[0], step()[0])


def test_moe_apply_waits_for_no_host_sync(dev):
    """The dispatch counts with comparisons, not bincount, and never reads
    a value back: under ``set_sync_debug_mode("error")`` nothing raises."""
    from repro_torch.models.moe import moe_apply

    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    layer = {n: t[0] for n, t in tf.init(cfg, 0, dev)["layers"].items()}
    x = torch.randn((8, 1, cfg.d_model), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for groups in (8, 1):
            y, aux = moe_apply(layer, x, cfg, groups=groups)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))


def test_faithful_moe_rounds_repeat_bit_for_bit(dev):
    """Per-example gradients through the MoE dispatch (``torch.func.vmap``):
    two sigma = 0 DeCaPH rounds give the same parameters bit for bit."""
    import repro_torch.arms as arms
    from repro_torch.core.dp import DPConfig
    from repro_torch.serve.federation import token_silos
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    model = transformer_model(cfg, device=str(dev))
    assert model.ghost is None
    silos = token_silos(cfg, hospitals=3, n_per=8, seq_len=8, seed=0)
    acfg = arms.ArmConfig(rounds=2, batch_size=6, lr=0.05, use_secagg=False,
                          dp=DPConfig(clip_norm=1.0, noise_multiplier=0.0,
                                      microbatch_size=4))
    a, b = (tree_leaves(arms.run("decaph", model, silos, acfg).params)
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _cross_caches(cfg, params, cache, frames):
    """Each decoder layer's cross K/V of one ``_encode``, into the cache."""
    from repro_torch.models import attention as attn_lib

    enc = tf._encode(cfg, params, frames)
    for (_, p), c in zip(tf.layers_of(cfg, params), tf.layer_caches(cfg,
                                                                    cache)):
        for key, t in attn_lib.cross_kv_cache(p, enc, cfg).items():
            c["cross"][key].copy_(t)


def test_whisper_at_group_one_on_the_card_matches_the_cpu(dev):
    """Whisper's smoke stack at the full config's heads (12 on 12 of 64,
    group 1) in float32: the ``use_flash`` forward at a decoder length of
    100 (not a multiple of the reference's 128-row block) launches the
    kernel once per decoder layer and none for the non-causal encoder;
    its logits, and a prefill and a ragged decode step over the cross
    caches (one decode launch per layer and position), match the CPU at
    1e-4."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("whisper-small").replace(
        n_heads=12, n_kv_heads=12, head_dim=64, use_decode_kernel=True)
    params = tf.init(cfg, 0, "cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    g = torch.Generator().manual_seed(4)
    frames = 0.05 * torch.randn((2, cfg.n_audio_ctx, cfg.d_model), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=g)
    positions = torch.tensor([6, 3], dtype=torch.int32)
    out = {}
    for where, p in (("cpu", params), ("cuda", on_card)):
        batch = {"tokens": tokens.to(where), "frames": frames.to(where)}
        flash_ops.reset_launches()
        with torch.no_grad():
            logits, _ = tf.forward(cfg.replace(use_flash=True), p, batch)
        if where == "cuda":
            assert flash_ops.launches("simt_fp32") == cfg.n_layers == 2
        cache = tf.init_cache(cfg, 2, 12, where)
        _cross_caches(cfg, p, cache, batch["frames"])
        first, cache = tf.prefill(cfg, p, cache, batch["tokens"][:, :6])
        before = decode_ops.launches()
        step, cache = tf.decode_step_positions(
            cfg, p, cache, batch["tokens"][:, 6:7], positions.to(where))
        if where == "cuda":
            assert decode_ops.launches() == before + cfg.n_layers
        out[where] = {"forward": logits, "prefill": first, "step": step,
                      "cache": cache}
    for a, b in zip(tree_leaves(out["cpu"]), tree_leaves(out["cuda"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


def test_deepseek_decode_step_on_the_card_matches_the_cpu(dev):
    """DeepSeek-V3's smoke stack (MLA, dense then MoE) in float32: a
    prefill and a ragged per-row decode step on the card against the CPU
    at 1e-4 (logits and the compressed cache), no decode kernel launch
    (MLA has none), and the step again bit for bit under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config("deepseek-v3-671b").replace(
        use_decode_kernel=True)
    params = tf.init(cfg, 0, "cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (3, 5), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (3, 1), generator=g)
    positions = torch.tensor([5, 2, 9], dtype=torch.int32)
    out = {}
    before = decode_ops.launches()
    for where, p in (("cpu", params), ("cuda", on_card)):
        cache = tf.init_cache(cfg, 3, 12, where)
        first, cache = tf.prefill(cfg, p, cache, prompt.to(where))
        logits, cache = tf.decode_step_positions(
            cfg, p, cache, tokens.to(where), positions.to(where))
        out[where] = {"prefill": first, "step": logits, "cache": cache}
    assert decode_ops.launches() == before
    for a, b in zip(tree_leaves(out["cpu"]), tree_leaves(out["cuda"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)
    snapshot = tree_map(torch.clone, out["cuda"]["cache"])
    again_cache = tree_map(torch.clone, out["cuda"]["cache"])
    tokens, positions = tokens.to(dev), positions.to(dev)
    first, _ = tf.decode_step_positions(cfg, on_card, snapshot, tokens,
                                        positions)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, _ = tf.decode_step_positions(cfg, on_card, again_cache,
                                            tokens, positions)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(snapshot),
                                                 tree_leaves(again_cache)))


def _update_l2(initial, a, b) -> tuple[float, float]:
    """L2 of the two updates' difference and of b's update (float64)."""
    diff = upd = 0.0
    for p0, pa, pb in zip(tree_leaves(initial), tree_leaves(a),
                          tree_leaves(b)):
        ua, ub = pa.double() - p0.double(), pb.double() - p0.double()
        diff += float((ua - ub).square().sum())
        upd += float(ub.square().sum())
    return diff ** 0.5, upd ** 0.5


def test_launch_ghost_program_update_matches_per_example(dev):
    """``build_program``'s ghost and per-example train programs at sigma
    0, SGD lr 0.05, float32 with an untied head, SmolLM-360M's width at 4
    layers on 8 x 128 tokens: one step's updates within 2 lr C 1e-4 in L2
    (a relative norm error e moves the update by at most lr C e), and 29
    ``ghost_norm`` launches (7 a layer + the head) for the ghost step."""
    from repro_torch.configs.base import dense_stack
    from repro_torch.data import make_lm_stream
    from repro_torch.launch import steps

    cfg = get_config("smollm-360m").replace(
        n_layers=4, stack=dense_stack(4), optimizer="sgd", lr=0.05,
        dp_sigma=0.0, dp_clip=1.0, tie_embeddings=False,
        param_dtype="float32", compute_dtype="float32")
    params = tf.init(cfg, 0, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             make_lm_stream(cfg.vocab_size, 128, seed=1).batch(0, 8).items()}
    out = {}
    for mode in ("ghost", "per_example"):
        prog = steps.build_program(cfg, "train_4k", dev, dp_mode=mode)
        before = ghost_ops.launches()
        # repro: allow[prng-key-discipline] both modes draw the same noise on purpose: the test compares their updates
        gen = torch.Generator(device=dev).manual_seed(0)
        out[mode] = prog.fn(params, (), batch, gen)[0]
        assert ghost_ops.launches() - before == (29 if mode == "ghost" else 0)
    diff, upd = _update_l2(params, out["ghost"], out["per_example"])
    assert upd > 0
    assert diff <= 2 * 0.05 * 1.0 * 1e-4


def test_launch_program_args_allocate_nothing_on_the_card(dev):
    """Nemotron-4-340B's train_4k program (341 B parameters, their
    Adafactor state and a 256 x 4096 batch) as meta tensors: the card's
    allocated bytes do not move."""
    from repro_torch.launch import steps

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    prog = steps.build_program(get_config("nemotron-4-340b"), "train_4k", dev)
    assert torch.cuda.memory_allocated(dev) == before
    params, opt_state, batch = prog.args
    leaves = (tree_leaves(params) + tree_leaves(batch)
              + [t for part in opt_state for t in tree_leaves(part)])
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in tree_leaves(params)) > 340e9

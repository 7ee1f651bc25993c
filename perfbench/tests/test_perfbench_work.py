"""The operation and byte counts against hand counts at small shapes, and
the metric readers on made-up traces."""

import pytest

from perfbench.harness import spec, work
from perfbench.harness.trace import (TraceSummary, idle_gaps, label_gaps,
                                     union)

TINY = {"d_model": 4, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
        "head_dim": 2, "d_ff": 6, "vocab_size": 10, "ffn_kind": "swiglu",
        "compute_dtype": "bfloat16"}


def test_dense_widths_and_product_params():
    # per layer: wq 4x4, wk 4x2, wv 4x2, wo 4x4, gate 4x6, up 4x6, down 6x4
    per_layer = 16 + 8 + 8 + 16 + 24 + 24 + 24
    assert work.product_params(TINY) == 2 * per_layer + 4 * 10


def test_ghost_gram_work_by_hand():
    rows, seq = 3, 5
    # every product: its inputs' Gram (S(S+1)/2 pairs of 2 d_in ops) and its
    # output cotangents' (2 d_out), for each row
    pairs = seq * (seq + 1) // 2
    widths = [(4, 4), (4, 2), (4, 2), (4, 4), (4, 6), (4, 6), (6, 4)] * 2 \
        + [(4, 10)]
    ops = sum(rows * pairs * 2 * (a + b) for a, b in widths)
    nbytes = sum(rows * seq * (a + b) * 4 for a, b in widths)
    assert work.ghost_gram_work(TINY, rows, seq, "float32") == (ops, nbytes)
    least = max(ops / (495e12 / 3), nbytes / 3.35e12)
    assert work.ghost_gram_seconds(TINY, rows, seq, "float32") == \
        pytest.approx(least)


def test_flash_work_by_hand():
    b, s, h, kv, d = 2, 3, 2, 1, 4
    pairs = s * (s + 1) // 2                       # causal (query, key) pairs
    ops = b * h * pairs * 4 * d                    # QK^T and PV, 2 ops a MAC
    nbytes = 2 * (b * s * h * d * 2 + b * s * kv * d * 2)   # q, o; k, v
    assert work.flash_work(b, s, h, kv, d, "bfloat16") == (ops, nbytes)


def test_model_flops_by_hand():
    n = work.product_params(TINY)
    seq, tokens = 8, 16
    attn = 2 * TINY["n_layers"] * seq * TINY["n_heads"] * TINY["head_dim"]
    assert work.eval_flops(TINY, tokens, seq) == tokens * (2 * n + attn)
    assert work.train_flops(TINY, tokens, seq) == tokens * (6 * n + 3 * attn)


def _trace(**by_name):
    return TraceSummary(window_s=2.0, busy_s=1.5, device_s_by_name=by_name,
                        idle_by_label={"round": 0.5})


def test_training_readers():
    ctx = {"mc": TINY, "real_rows": 4, "seq_len": 8, "window_s": 2.0,
           "rounds": 2, "dispatches": 2, "param_dtype": ["float32"],
           "trace": _trace(**{"ghost_norm_tiles<float, float>": 1e-9,
                              "gemm": 1.0})}
    read = lambda m: spec.metric_reader(m).read(ctx)  # noqa: E731
    assert read("round_calls.train") == 1.0
    assert read("idle_share.train") == pytest.approx(25.0)
    least = work.ghost_gram_seconds(TINY, 4, 8, "float32")
    assert read("ghost_norm_roofline") == pytest.approx(100 * least / 1e-9)
    assert read("mfu.train") == pytest.approx(
        100 * work.train_flops(TINY, 32, 8) / (2.0 * 989e12))
    ctx["trace"] = _trace(gemm=1.0)
    assert read("ghost_norm_roofline") is None    # no kernel, no share
    ctx["trace"] = None
    assert read("idle_share.train") is None


def test_eval_readers():
    ctx = {"mc": {**TINY, "n_heads": 2}, "batches": 3, "batch_size": 2,
           "seq_len": 8, "tokens": 48, "window_s": 2.0,
           "trace": _trace(flash_attention_mma_kernel=1e-3)}
    read = lambda m: spec.metric_reader(m).read(ctx)  # noqa: E731
    per_call = work.flash_seconds(2, 8, 2, 1, 2, "bfloat16")
    assert read("flash_attention_roofline") == pytest.approx(
        100 * 3 * 2 * per_call / 1e-3)
    assert read("mfu.eval") == pytest.approx(
        100 * work.eval_flops(TINY, 48, 8) / (2.0 * 989e12))
    assert read("idle_share.eval") == pytest.approx(25.0)


def test_idle_gaps_and_their_labels():
    busy = union([(0, 2), (1, 3), (5, 6), (8, 9)])
    assert busy == [(0, 3), (5, 6), (8, 9)]
    gaps = idle_gaps(busy, 0, 10)
    assert gaps == [(3, 5), (6, 8), (9, 10)]
    spans = [(0, 10, 0, "round"), (2, 6.5, 1, "aggregate")]
    assert label_gaps(gaps, spans) == pytest.approx(
        {"aggregate": 2e-6, "round": 3e-6})

"""The span reductions of ``harness.spans`` and the span-read metrics on
made-up traces (times in microseconds, as the profiler's), and the
benchmark's readers unchanged on the extended summary."""

import dataclasses

import pytest

from perfbench.harness import spec
from perfbench.harness.spans import (SpanSummary, interpolate, overlap,
                                     pair_anchors, reduce_spans, subtract,
                                     top_level)
from perfbench.harness.trace import TraceSummary, union

TINY = {"d_model": 4, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
        "head_dim": 2, "d_ff": 6, "vocab_size": 10, "ffn_kind": "swiglu",
        "compute_dtype": "bfloat16"}
BASE = TraceSummary(
    window_s=2.0, busy_s=1.5,
    device_s_by_name={"ghost_norm_tiles<float, float>": 1e-6,
                      "flash_attention_mma_kernel<64>": 1e-3, "gemm": 1.0},
    idle_by_label={"round": 0.5})
CTX = {"mc": TINY, "real_rows": 4, "seq_len": 8, "window_s": 2.0,
       "rounds": 2, "dispatches": 2, "param_dtype": ["float32"],
       "batches": 3, "batch_size": 2, "tokens": 48}
# what each of the benchmark's readers read on BASE before the spans came
BEFORE = {"round_calls.train": 1.0,
          "ghost_norm_roofline": 0.4967164179104478,
          "mfu.train": 3.339130434782609e-09,
          "idle_share.train": 25.0,
          "flash_attention_roofline": 6.877611940298506e-05,
          "mfu.eval": 1.6695652173913044e-09,
          "idle_share.eval": 25.0}


def test_overlap_and_subtract():
    merged = union([(0, 2), (1, 3), (5, 6), (8, 9)])   # (0,3) (5,6) (8,9)
    starts = [a for a, _ in merged]
    assert overlap(2, 8.5, merged, starts) == 2.5
    assert overlap(3, 5, merged, starts) == 0.0
    assert overlap(-1, 10, merged, starts) == 5.0
    assert subtract([(0, 10)], [(2, 3), (2.5, 4), (9, 12)]) == \
        [(0, 2), (4, 9)]
    assert subtract([(0, 1), (5, 6)], []) == [(0, 1), (5, 6)]


def test_device_times_map_through_the_anchors():
    """Device us -> profiler us: piecewise linear through the anchors,
    straight past the ends."""
    xs, ys = [0.0, 10.0, 20.0], [100.0, 110.0, 125.0]   # the clock bends
    assert interpolate(5.0, xs, ys) == 105.0
    assert interpolate(10.0, xs, ys) == 110.0
    assert interpolate(16.0, xs, ys) == 119.0
    assert interpolate(-2.0, xs, ys) == 98.0
    assert interpolate(24.0, xs, ys) == 131.0
    assert interpolate(3.0, [0.0, 0.0, 8.0], [7.0, 7.0, 15.0]) == 10.0


def test_marks_pair_with_their_anchors_where_some_are_lost():
    marks = [0.0, 100.0, 103.0, 500.0, 900.0]        # device us
    anchors = [1010.0, 1111.0, 1114.0, 1508.0, 1912.0]  # offset 1010 +- 2
    assert pair_anchors(marks, anchors, 1000.0) == list(zip(marks, anchors))
    # the profiler lost the anchor of the mark at 500: it goes unpaired
    kept = anchors[:3] + anchors[4:]
    assert pair_anchors(marks, kept, 1000.0) == \
        [(0.0, 1010.0), (100.0, 1111.0), (103.0, 1114.0), (900.0, 1912.0)]
    # and the first one's
    assert pair_anchors(marks, anchors[1:], 1010.0) == \
        list(zip(marks[1:], anchors[1:]))


def test_top_level_spans_are_those_no_span_holds():
    ev = [{"ts": 0.0, "dur": 10.0}, {"ts": 1.0, "dur": 2.0},
          {"ts": 11.0, "dur": 1.0}, {"ts": 11.5, "dur": 2.0}]
    # the last one starts inside the third but outlives it: no parent
    assert top_level(ev) == [True, False, True, True]


def test_device_seconds_by_span_and_coverage():
    busy = union([(0, 4), (6, 10), (12, 20)])
    spans = [(0, 11, "round", True), (1, 3, "clip", False),
             (7, 9, "clip", False), (8, 10, "dp.noise", False),
             (12, 16, "fused_round", True)]
    by_span, covered = reduce_spans(spans, busy)
    assert by_span == pytest.approx({"round": 8e-6, "clip": 4e-6,
                                     "dp.noise": 2e-6, "fused_round": 4e-6})
    assert covered == pytest.approx(12e-6)      # (16, 20) lies outside


def _summary(**extra):
    return SpanSummary(**dataclasses.asdict(BASE), **extra)


def test_breakdown_and_kernel_placement():
    s = _summary(
        device_s_by_span={"round": 1.0, "clip": 0.9, "model.loss": 0.1},
        ops=[(0, 4, "ghost_norm_tiles"), (4, 6, "ghost_norm_rows"),
             (0, 2, "flash_attention_mma_kernel"),
             (3, 5, "flash_attention_mma_kernel"), (0, 9, "gemm")],
        spans=[(0, 5, "clip", False), (0, 10, "model.loss_fn", True),
               (4, 6, "model.loss", False)])
    out = s.breakdown()
    assert out["device_spans"] == [["round", 1.0], ["clip", 0.9],
                                   ["model.loss", 0.1]]
    assert out["device_ops"] == BASE.breakdown()["device_ops"]
    assert out["idle_gaps"] == BASE.breakdown()["idle_gaps"]
    assert s.kernel_share(("ghost_norm",), ("clip",)) == pytest.approx(5 / 6)
    assert s.kernel_share(("flash_attention",), ("model.loss_fn",),
                          ("model.loss",)) == pytest.approx(3 / 4)
    assert s.kernel_share(("decode_attention",), ("clip",)) is None


def test_span_readers():
    s = _summary(device_s_by_span={"clip": 0.9, "model.loss": 0.012},
                 counters={"rows.real": 9.0, "rows.computed": 32.0})
    read = lambda m, **kw: spec.metric_reader(m).read(  # noqa: E731
        {**CTX, "trace": s, **kw})
    assert read("real_rows.train") == pytest.approx(28.125)
    assert read("clip_ms.train") == pytest.approx(450.0)
    assert read("loss_ms.eval") == pytest.approx(4.0)
    assert read("clip_ms.train", rounds=0) is None


@pytest.mark.parametrize("name", ["real_rows.train", "clip_ms.train",
                                  "loss_ms.eval"])
def test_span_readers_read_nothing_without_spans(name):
    """The benchmark's own ``Trace`` (a parent's program, or no span
    trace), an empty window and no trace at all read nothing."""
    reader = spec.metric_reader(name)
    assert reader.read({**CTX, "trace": BASE}) is None
    assert reader.read({**CTX, "trace": _summary()}) is None
    assert reader.read({**CTX, "trace": None}) is None


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_benchmark_readers_read_as_before(name):
    reader = spec.metric_reader(name)
    spans = _summary(device_s_by_span={"clip": 0.9}, covered_s=1.5,
                     counters={"rows.real": 9.0, "rows.computed": 32.0})
    assert reader.read({**CTX, "trace": BASE}) == BEFORE[name]
    assert reader.read({**CTX, "trace": spans}) == BEFORE[name]

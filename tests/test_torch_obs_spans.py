"""The port's layer spans and row counters (``repro_torch.obs``), on the CPU.

A fake device clock gives device-timed spans their ``dev_ts``/``dev_dur``;
with recording off every new call site gets the shared no-op context; with
it on, a DeCaPH round and an evaluation loss record the span trees the
benchmark's readers rely on, and the row counters count what the round
drew and computed.
"""

import pytest
import torch

import repro_torch.arms as arms
import repro_torch.obs as obs
from repro_torch.arms import fused
from repro_torch.arms.base import default_pad
from repro_torch.configs import get_smoke_config
from repro_torch.core.dp import DPConfig
from repro_torch.models import transformer as tf
from repro_torch.obs.recorder import Recorder, read_events, validate_events
from repro_torch.serve.federation import token_silos, transformer_model
from repro.obs.recorder import validate_events as jvalidate_events

torch.set_num_threads(1)

HOSPITALS, N_PER, SEQ, BATCH = 3, 16, 12, 12
TRAIN_SPANS = {"round", "fused_round", "jit_dispatch", "fused.to_device",
               "clip", "ghost.norms", "ghost.grads", "dp.noise",
               "fused.reduce", "fused.sync", "aggregate"}
EVAL_SPANS = {"model.loss_fn", "model.embed", "model.block", "model.mixer",
              "model.ffn", "model.head", "model.loss"}


class FakeClock:
    """Marks are consecutive integers; a mark is ``UNIT`` device seconds
    after the one before it."""

    UNIT = 0.25

    def __init__(self):
        self.n, self.syncs = 0, 0
        self.epoch = self.mark()

    def mark(self):
        self.n += 1
        return self.n - 1

    def seconds(self, a, b):
        return (b - a) * self.UNIT

    def synchronize(self):
        self.syncs += 1


def test_fake_device_clock_times_nested_spans():
    clock = FakeClock()
    rec = Recorder(device_clock=clock)
    with rec.span("outer", device_time=True):          # marks 1 and 4
        with rec.span("inner", device_time=True, k=1):  # marks 2 and 3
            pass
        with rec.span("host"):                          # no marks
            pass
    by_name = {ev["name"]: ev for ev in rec.events()}
    assert "dev_ts" not in by_name["outer"]        # nothing waited for yet
    assert rec.resolve_device_times() == 2 and clock.syncs == 1
    assert (by_name["outer"]["dev_ts"], by_name["outer"]["dev_dur"]) == \
        (0.25, 0.75)
    assert (by_name["inner"]["dev_ts"], by_name["inner"]["dev_dur"]) == \
        (0.5, 0.25)
    assert by_name["inner"]["args"] == {"k": 1}
    assert by_name["inner"]["depth"] == 1
    assert "dev_ts" not in by_name["host"]
    assert rec.resolve_device_times() == 0 and clock.syncs == 1


def test_device_time_without_a_clock_marks_nothing():
    rec = Recorder()
    with rec.span("s", device_time=True):
        pass
    assert rec.resolve_device_times() == 0
    (ev,) = rec.events()
    assert "dev_ts" not in ev and "dev_dur" not in ev


def test_export_resolves_and_both_validators_read_it(tmp_path):
    clock = FakeClock()
    with obs.recording(Recorder(device_clock=clock)):
        with obs.span("a", device_time=True):
            obs.counter("rows.real", 3)
        paths = obs.export(tmp_path)
    events = read_events(paths["events"])
    (span,) = [ev for ev in events if ev["type"] == "span"]
    assert span["dev_ts"] == 0.25 and span["dev_dur"] == 0.25
    assert validate_events(events)["counter_totals"] == {"rows.real": 3}
    assert jvalidate_events(events)["by_type"] == \
        {"meta": 1, "span": 1, "counter": 1}


def test_recorder_has_no_gauge():
    assert not hasattr(Recorder(), "gauge")
    assert not hasattr(obs, "gauge")


# -- the port's call sites ----------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("smollm-360m").replace(tie_embeddings=False)
    return {"cfg": cfg, "model": transformer_model(cfg, device="cpu"),
            "silos": token_silos(cfg, hospitals=HOSPITALS, n_per=N_PER,
                                 seq_len=SEQ)}


def _decaph(lm, rounds):
    return arms.run("decaph", lm["model"], lm["silos"], arms.ArmConfig(
        rounds=rounds, batch_size=BATCH, use_secagg=False,
        clipping="ghost", dp=DPConfig(clip_norm=1.0, noise_multiplier=0.5)))


def _eval_batch(lm):
    x, y = lm["silos"][0].x[:2], lm["silos"][0].y[:2]
    return {"tokens": torch.as_tensor(x), "labels": torch.as_tensor(y)}


def _loss(lm):
    params = lm["model"].init_fn(0)
    with torch.no_grad():
        return tf.loss_fn(lm["cfg"], params, _eval_batch(lm))


def test_recording_off_every_new_site_gets_the_shared_null(lm, monkeypatch):
    calls = []
    span, counter = obs.span, obs.counter

    def spy_span(name, **kw):
        ctx = span(name, **kw)
        calls.append((name, ctx is obs._NULL))
        return ctx

    def spy_counter(name, inc=1.0, **kw):
        calls.append((name, obs.recorder() is None))
        counter(name, inc, **kw)

    monkeypatch.setattr(obs, "span", spy_span)
    monkeypatch.setattr(obs, "counter", spy_counter)
    assert obs.recorder() is None
    _decaph(lm, 1)
    _loss(lm)
    names = {n for n, _ in calls}
    assert TRAIN_SPANS | EVAL_SPANS <= names
    assert {"rows.real", "rows.computed"} <= names
    assert all(null for _, null in calls)
    assert obs.recorder() is None


def _parents(events):
    """Each span event's innermost enclosing span (same thread, one level
    up, holding it on the host's clock), or None."""
    spans = [ev for ev in events if ev["type"] == "span"]
    out = []
    for ev in spans:
        up = [p for p in spans if p["tid"] == ev["tid"]
              and p["depth"] == ev["depth"] - 1 and p["ts"] <= ev["ts"]
              and p["ts"] + p["dur"] >= ev["ts"] + ev["dur"]]
        out.append((ev, up[0] if up else None))
    return out


def _parent_names(events, name):
    return {p["name"] if p else None for ev, p in _parents(events)
            if ev["name"] == name}


def test_decaph_round_span_tree(lm):
    with obs.recording() as rec:
        _decaph(lm, 1)
    events = rec.events()
    names = {ev["name"] for ev in events if ev["type"] == "span"}
    assert TRAIN_SPANS <= names
    assert _parent_names(events, "round") == {"arms.run"}
    assert _parent_names(events, "fused_round") == {"round"}
    assert _parent_names(events, "aggregate") == {"round"}
    assert _parent_names(events, "jit_dispatch") == {"fused_round"}
    assert _parent_names(events, "fused.to_device") == {"fused_round"}
    assert _parent_names(events, "fused.sync") == {"fused_round"}
    for name in ("clip", "dp.noise", "fused.reduce"):
        assert _parent_names(events, name) == {"jit_dispatch"}
    for name in ("ghost.norms", "ghost.grads"):
        assert _parent_names(events, name) == {"clip"}
    clips = [ev for ev in events if ev["name"] == "clip"]
    assert [(c["args"]["slot"], c["args"]["hospital"], c["args"]["t"])
            for c in clips] == [(s, s, 0) for s in range(HOSPITALS)]
    # the forward's model spans belong to evaluation, not the ghost path
    assert not names & EVAL_SPANS


def test_eval_loss_span_tree(lm):
    with obs.recording() as rec:
        loss = _loss(lm)
    events = rec.events()
    assert torch.isfinite(loss)
    n_layers = lm["cfg"].n_layers
    blocks = [ev for ev in events if ev["name"] == "model.block"]
    assert [b["args"]["layer"] for b in blocks] == list(range(n_layers))
    for name in ("model.block", "model.embed", "model.head", "model.loss"):
        assert _parent_names(events, name) == {"model.loss_fn"}
    for name in ("model.mixer", "model.ffn"):
        assert _parent_names(events, name) == {"model.block"}
        assert sum(ev["name"] == name for ev in events) == n_layers
    assert _parent_names(events, "model.loss_fn") == {None}


def test_row_counters_count_drawn_and_computed_rows(lm, monkeypatch):
    rounds = 3
    counts = []
    stack_poisson = fused.stack_poisson

    def spy(*args, **kw):
        cb = stack_poisson(*args, **kw)
        counts.extend(cb.counts.tolist())
        return cb

    monkeypatch.setattr(fused, "stack_poisson", spy)
    with obs.recording() as rec:
        report = _decaph(lm, rounds)
    totals = rec.counter_totals()
    assert totals["rows.real"] == sum(log.aggregate_batch
                                      for log in report.logs)
    pad = default_pad(BATCH / (HOSPITALS * N_PER), lm["silos"],
                      arms.ArmConfig())
    draws = [ev for ev in rec.events()
             if ev["name"] == "host_rng.stack_poisson"]
    assert [ev["args"] for ev in draws] == \
        [{"cohort": HOSPITALS, "pad": pad}] * rounds
    # without a mesh executor each slot's clip function is handed its
    # draw's rows alone, and a slot that drew none is not clipped
    assert totals["rows.computed"] == totals["rows.real"] > 0
    assert len(counts) == rounds * HOSPITALS
    assert totals.get("clip.empty_slots", 0) == counts.count(0)

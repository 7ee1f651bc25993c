"""A whole run of each cell on the CPU at small widths (the look for a card
skipped): sound, ``correct`` is true; with the timed path broken
underneath, ``correct`` is false, once for each fault the cell can have,
also where the fault starts only in the window; and the controls, the
plain reference put in the program's place in TF32 (the training
window's float32 one step down) or float8 (bf16's), read apart from the
program."""

import numpy as np
import pytest

from perfbench.harness import checks, spec
from perfbench.harness.cell import run_cell
from perfbench.tests._smoke import SMOKE_MIX, smoke_config

BENCH = spec.benchmark()
CELLS = {c["name"]: spec.traffic(c["traffic"])["kind"]
         for c in BENCH["workloads"]}
TRAIN = [c for c, k in CELLS.items() if k == "decaph_train"]
EVAL = [c for c, k in CELLS.items() if k == "eval"]
SEED = 2**31 + 101


def _run(cell, variants=()):
    mc = spec.config(spec.workload(BENCH, cell)["config"])
    return run_cell(cell, SEED, 0.2, False, device="cpu",
                    config_overrides=smoke_config(mc),
                    mix_overrides=SMOKE_MIX[CELLS[cell]], variants=variants)


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_is_correct_and_its_control_reads_apart(cell):
    """Sound, the run is correct; each control reads at least three times
    the program's gap on one number, and a training cell's float8 control
    fails the cell's limits already at these widths."""
    controls = ("fp8", "tf32") if cell in TRAIN else ("fp8",)
    out = _run(cell, variants=controls)
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["result"]["attempted"] >= 1 and out["result"]["failed"] == 0
    prog = {k: c["value"] for k, c in out["result"]["checks"].items()}
    for name in controls:
        ctl = out["variants"][name]
        assert any(ctl[k] >= 3 * prog[k] > 0 for k in prog), (name, prog,
                                                              ctl)
    if cell in TRAIN:
        ok, shown = checks.judge(out["variants"]["fp8"], spec.limits(cell))
        assert not ok, shown


def _frozen(monkeypatch):
    """A step that returns its state unchanged."""
    import repro_torch.arms.decaph as decaph

    monkeypatch.setattr(decaph, "sgd_update",
                        lambda params, grads, lr, wd: params)


def _half(monkeypatch):
    """Half of each hospital's batch left out, the mean over the rest."""
    import repro_torch.arms.fused as fused

    draw = fused.stack_poisson

    def halved(*args, **kwargs):
        cb = draw(*args, **kwargs)
        for s, k in enumerate(cb.counts):
            keep = int(k) // 2
            cb.masks[s, keep:] = 0.0
            cb.counts[s] = keep
            cb.sizes[s] = keep
        return cb

    monkeypatch.setattr(fused, "stack_poisson", halved)


@pytest.mark.parametrize("fault", [_frozen, _half], ids=["frozen", "half"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_are_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell)["result"]["correct"]


def _from_window(monkeypatch, followed, module, name, fault):
    """``module.name`` sound in the ``followed`` rounds that set-up drives,
    and with ``fault`` from the window's first round on."""
    sound = getattr(module, name)
    calls = []

    def call(*args, **kwargs):
        calls.append(1)
        out = sound(*args, **kwargs)
        return fault(out, *args) if len(calls) > followed else out

    monkeypatch.setattr(module, name, call)


def _frozen_in_window(monkeypatch, followed):
    import repro_torch.arms.decaph as decaph

    _from_window(monkeypatch, followed, decaph, "sgd_update",
                 lambda new, params, *rest: params)


def _half_in_window(monkeypatch, followed):
    import repro_torch.arms.fused as fused

    def halve(cb, *args):
        for s, k in enumerate(cb.counts):
            keep = int(k) // 2
            cb.masks[s, keep:] = 0.0
            cb.counts[s] = keep
            cb.sizes[s] = keep
        return cb

    _from_window(monkeypatch, followed, fused, "stack_poisson", halve)


@pytest.mark.parametrize("fault", [_frozen_in_window, _half_in_window],
                         ids=["frozen", "half"])
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_from_the_window_on_are_not_correct(cell, fault,
                                                             monkeypatch):
    """A fault that leaves the rounds of set-up sound is caught on the
    window's last round."""
    fault(monkeypatch, spec.traffic(spec.workload(BENCH, cell)["traffic"])[
        "followed_rounds"])
    res = _run(cell)["result"]
    assert not res["correct"]
    assert res["checks"]["last_grad_gap"]["value"] > \
        res["checks"]["last_grad_gap"]["limit"]


def test_the_planted_half_batch_keeps_the_arrays_shape(monkeypatch):
    import repro_torch.arms.fused as fused
    from repro_torch.arms.base import Participant

    _half(monkeypatch)
    parts = [Participant(np.zeros((40, 3), np.int32),
                         np.zeros((40, 3), np.int32)) for _ in range(2)]
    cb = fused.stack_poisson(np.random.default_rng(0), parts, [0, 1], 0.5, 32)
    assert cb.masks.shape == (2, 32)
    assert list(cb.masks.sum(axis=1)) == cb.sizes


def _answer_altered(monkeypatch):
    """Each batch's loss altered by 1% where it is produced."""
    import repro_torch.models.transformer as tf

    score = tf.loss_fn
    monkeypatch.setattr(tf, "loss_fn",
                        lambda cfg, params, batch:
                        score(cfg, params, batch) * 1.01)


def _half_rows(monkeypatch):
    """Half of each batch left out, the mean over the rest."""
    import repro_torch.models.transformer as tf

    score = tf.loss_fn
    monkeypatch.setattr(tf, "loss_fn", lambda cfg, params, batch: score(
        cfg, params, {k: v[:v.shape[0] // 2] for k, v in batch.items()}))


@pytest.mark.parametrize("fault", [_answer_altered, _half_rows],
                         ids=["answer", "half"])
@pytest.mark.parametrize("cell", EVAL)
def test_eval_faults_are_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell)["result"]["correct"]

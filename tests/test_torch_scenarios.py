"""``repro_torch.scenarios`` against ``repro.scenarios``.

Specs, presets and sweeps are the reference's: every preset and every cell
both registries share has the reference's ``spec_hash()`` (the
``backend-matrix`` sweep's ``shard`` cells too), JSON round-trips, and
validation fails with the reference's messages.  The cache serves hits
without the executor and recomputes corrupt or foreign entries.
``run_spec`` gives the reference's metrics rows: on ``gemini-small``
(``fl``, ``ideal`` and ``sim``) ε bit for bit, the losses within 1e-5,
the accuracy and every ``SimTiming`` field equal; the GEMINI MLP cell the
same with the reference's weights carried in (``tabular_params_from_jax``).
The "lm" pooled next-token accuracy on carried ``lm-small`` weights is the
reference's.  The report layer's fits and markdown are the reference's on
the same rows.  The spawn pool keeps the survivors of a failing cell, on
the CPU.  The CLI lists, runs and caches, and names its artifacts
``BENCH_torch_*``.
"""

import dataclasses
import json
import logging
import math
import os

import jax
import numpy as np
import pytest
import torch

import repro.scenarios as jsc
from repro.scenarios import cli as jcli
from repro.scenarios import report as jreport
from repro_torch.convert import params_from_jax, tabular_params_from_jax
import repro_torch.scenarios as sc
from repro_torch.scenarios import cli, executor, presets, report

torch.set_num_threads(1)

ATOL = 1e-5


# -- ScenarioSpec, presets and sweeps ----------------------------------------


@pytest.mark.parametrize("name", sorted(jsc.all_presets()))
def test_preset_hash_is_the_references(name):
    ours, ref = sc.get_preset(name), jsc.get_preset(name)
    assert ours.to_dict() == ref.to_dict()
    assert ours.hash_material() == ref.hash_material()
    assert ours.spec_hash() == ref.spec_hash()
    assert set(sc.all_presets()) == set(jsc.all_presets())


@pytest.mark.parametrize("sweep", sorted(jsc.SWEEPS))
def test_sweep_cells_hash_as_the_references(sweep):
    ours = {s.name: s.spec_hash() for s in sc.get_sweep(sweep).specs()}
    ref = {s.name: s.spec_hash() for s in jsc.get_sweep(sweep).specs()}
    assert ours == ref
    if sweep == "backend-matrix":
        # the backend axis is the live registry, the reference's own
        assert {n for n in ours if "backend=shard" in n} != set()
        assert sc.get_sweep(sweep).axes["backend"] == \
            jsc.get_sweep(sweep).axes["backend"] == ["ideal", "population",
                                                     "shard", "sim"]


def test_spec_json_roundtrip_and_labels():
    spec = sc.get_preset("gemini-5hospital-churn")
    back = sc.ScenarioSpec.from_json(spec.to_json())
    assert back == spec and back.spec_hash() == spec.spec_hash()
    assert spec.to_json() == jsc.get_preset("gemini-5hospital-churn").to_json()
    relabeled = spec.replace(name="other", tags=("x",))
    assert relabeled.spec_hash() == spec.spec_hash()
    for field, value in (("seed", 7), ("arm", "fl"), ("backend", "ideal"),
                         ("noise_multiplier", 1.3)):
        changed = {"topology": None, "nodes": None} if field == "backend" \
            else {}
        assert spec.replace(**{field: value}, **changed).spec_hash() != \
            spec.spec_hash()


BAD_SPECS = [
    {"task": "mri"},
    {"backend": "cloud"},
    {"hospitals": 0},
    {"straggler_ratio": 1.5},
    {"hospitals": 3, "nodes": [{"throughput": 10.0}] * 2},
    {"participation_rate": 0.0},
    {"participation_rate": 0.5},
    {"participation_rate": 0.5, "backend": "ideal"},
    {"backend": "ideal", "straggler_ratio": 0.2},
    {"backend": "population"},
    {"backend": "population", "use_secagg": False, "arm": "gossip"},
    {"population": {"degree": 3}, "nodes": [{}] * 5},
    {"population": {"hospitals": 9}},
    {"population": {"topology": "torus"}},
    {"model_size": "huge"},
    {"clipping": "sometimes"},
    {"arm": ""},
    {"lr": -1.0},
    {"features": 0},
    {"bogus": 1},
]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: ",".join(d))
def test_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        jsc.ScenarioSpec.from_dict(bad)
    with pytest.raises(ValueError) as ours:
        sc.ScenarioSpec.from_dict(bad)
    # the backend list is the live registry, the reference's own
    assert str(ours.value) == str(ref.value)


# -- the result cache --------------------------------------------------------


def _fake_result(spec, **overrides):
    out = {
        "name": spec.name, "key": spec.spec_hash(), "task": spec.task,
        "arm": spec.arm, "backend": spec.backend,
        "hospitals": spec.hospitals, "model_size": spec.model_size,
        "model_params": 9, "rounds_completed": spec.rounds,
        "epsilon": 1.0, "mean_loss": 0.5, "accuracy": 0.9,
        "wall_clock": 1.0, "bytes_on_wire": 100.0, "dropout_events": 0,
        "recoveries": 0, "lost_rounds": 0, "events": 10,
        "host_seconds": 0.01,
    }
    out.update(overrides)
    return out


def test_cache_hit_skips_executor_and_changed_spec_misses(tmp_path):
    cache = sc.ResultCache(tmp_path)
    spec = sc.ScenarioSpec(name="cell", arm="fl", rounds=2)
    calls = []

    def counting_runner(s):
        calls.append(s.spec_hash())
        return _fake_result(s)

    first = sc.run_sweep([spec], cache, runner=counting_runner)
    assert (first.hits, first.misses) == (0, 1) and len(calls) == 1
    again = sc.run_sweep([spec.replace(name="renamed")], cache,
                         runner=counting_runner)
    assert (again.hits, again.misses) == (1, 0) and len(calls) == 1
    assert again.results[0] == {**first.results[0], "name": "renamed"}
    reseeded = spec.replace(seed=99)
    third = sc.run_sweep([spec, reseeded], cache, runner=counting_runner)
    assert (third.hits, third.misses) == (1, 1)
    assert calls[-1] == reseeded.spec_hash()
    assert len(cache) == 2
    assert sc.DEFAULT_CACHE_DIR == ".sweep_cache_torch"


def test_cache_corrupted_entry_recomputed_with_warning(tmp_path, caplog):
    cache = sc.ResultCache(tmp_path)
    spec = sc.ScenarioSpec(name="cell", arm="fl", rounds=2)
    cache.put(spec, _fake_result(spec))
    cache.path(spec).write_text("{ not json")
    calls = []

    def counting_runner(s):
        calls.append(s.name)
        return _fake_result(s)

    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.scenarios.cache"):
        outcome = sc.run_sweep([spec], cache, runner=counting_runner)
    assert outcome.misses == 1 and calls == ["cell"]
    assert any("corrupted cache entry" in r.message for r in caplog.records)
    assert cache.get(spec) is not None


@pytest.mark.parametrize("entry", [
    lambda spec: {"schema": 1, "key": "deadbeef", "spec": {},
                  "result": _fake_result(spec)},
    lambda spec: {"schema": 1, "key": spec.spec_hash(),
                  "spec": spec.to_dict(), "result": {"arm": "fl"}},
    lambda spec: {"schema": 2, "key": spec.spec_hash(),
                  "spec": spec.to_dict(), "result": _fake_result(spec)},
], ids=["key-mismatch", "missing-fields", "schema"])
def test_cache_rejects_foreign_entries(tmp_path, entry):
    cache = sc.ResultCache(tmp_path)
    spec = sc.ScenarioSpec(name="cell", arm="fl")
    cache.path(spec).write_text(json.dumps(entry(spec)))
    assert cache.get(spec) is None
    assert not cache.path(spec).exists()  # evicted


# -- run_spec against the reference -----------------------------------------


def _gemini_small(backend):
    return dict(name="gemini-small", backend=backend, arm="fl",
                features=8, examples=400, rounds=4, hospitals=4)


@pytest.mark.parametrize("backend", ["ideal", "sim"])
def test_run_spec_rows_match_reference_on_gemini_small(backend):
    kw = _gemini_small(backend)
    ours = sc.run_spec(sc.get_preset("gemini-small").replace(**kw),
                       device="cpu")
    ref = jsc.run_spec(jsc.get_preset("gemini-small").replace(**kw))
    assert ours.keys() == ref.keys()
    for key in ours:
        if key == "host_seconds":
            continue
        if key == "mean_loss" and ref[key] is not None:
            assert abs(ours[key] - ref[key]) <= ATOL
        else:
            assert ours[key] == ref[key], key
    assert (ours["wall_clock"] > 0) == (backend == "sim")


def test_run_spec_rows_match_reference_with_carried_mlp_weights(monkeypatch):
    """The GEMINI MLP (``gemini-medium``) under DeCaPH with SecAgg at
    sigma 0 on ``ideal``: the reference's weights carried in."""
    spec_kw = dict(backend="ideal", features=12, examples=480, rounds=3,
                   hospitals=4, noise_multiplier=0.0)
    jspec = jsc.get_preset("gemini-medium").replace(**spec_kw)
    jmodel = jsc.presets.build_model(jspec)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jmodel.init_fn(jax.random.key(0)))
    build = presets.build_model

    def carried(spec, *, device="cuda"):
        return dataclasses.replace(
            build(spec, device=device),
            init_fn=lambda seed: tabular_params_from_jax(p0, device=device))

    monkeypatch.setattr(presets, "build_model", carried)
    ours = sc.run_spec(sc.get_preset("gemini-medium").replace(**spec_kw),
                       device="cpu")
    ref = jsc.run_spec(jspec)
    assert ours["model_params"] == ref["model_params"] == 12 * 64 + 64 + 65
    assert ours["epsilon"] == ref["epsilon"] and math.isinf(ours["epsilon"])
    assert abs(ours["mean_loss"] - ref["mean_loss"]) <= ATOL
    assert ours["accuracy"] == ref["accuracy"]
    assert ours["rounds_completed"] == ref["rounds_completed"] == 3


def test_lm_pooled_metric_matches_reference_on_carried_weights():
    jspec, spec = jsc.get_preset("lm-small"), sc.get_preset("lm-small")
    jmodel = jsc.presets.build_model(jspec)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jmodel.init_fn(jax.random.key(0)))
    params = params_from_jax(p0, presets.lm_model_config("small"),
                             device="cpu")
    model = presets.build_model(spec, device="cpu")
    silos, jsilos = presets.build_silos(spec), jsc.presets.build_silos(jspec)
    for a, b in zip(silos, jsilos):
        np.testing.assert_array_equal(a.x, b.x)
    ours = presets.pooled_metric(spec, model, params, silos)
    ref = jsc.presets.pooled_metric(jspec, jmodel, p0, jsilos)
    assert ours == ref and 0.0 <= ours <= 1.0
    assert model.ghost is not None  # the untied stack declares ghost


def test_lm_ghost_and_per_example_cells_agree():
    """The capacity-lm pair at "small" (cut to 2 rounds): the same ε, and
    at sigma 0 the same update within 1e-5."""
    base = dict(task="lm", model_size="small", hospitals=4, examples=48,
                rounds=2, batch_size=16, lr=0.1, backend="ideal",
                use_secagg=False, noise_multiplier=0.0)
    rows = {c: sc.run_spec(sc.ScenarioSpec(clipping=c, **base), device="cpu")
            for c in ("ghost", "per-example")}
    g, f = rows["ghost"], rows["per-example"]
    assert g["epsilon"] == f["epsilon"]
    assert abs(g["mean_loss"] - f["mean_loss"]) <= ATOL
    assert g["model_params"] == f["model_params"]


def test_spawn_pool_caches_survivors_when_one_cell_fails(tmp_path):
    good = sc.ScenarioSpec(name="good", task="gemini", model_size="small",
                           features=6, examples=160, rounds=2, batch_size=24,
                           backend="sim", use_secagg=False, arm="fl")
    bad = good.replace(name="bad", arm="no-such-arm")  # fails in the worker
    cache = sc.ResultCache(tmp_path)
    with pytest.raises(KeyError, match="no-such-arm"):
        sc.run_sweep([bad, good], cache, jobs=2, device="cpu")
    assert cache.get(good) is not None
    assert cache.get(bad) is None
    resumed = sc.run_sweep([good], cache, jobs=2, device="cpu")
    assert (resumed.hits, resumed.misses) == (1, 0)
    inline = executor.run_spec(good, device="cpu")
    assert {k: v for k, v in inline.items() if k != "host_seconds"} == \
        {k: v for k, v in cache.get(good).items() if k != "host_seconds"}


# -- the report layer --------------------------------------------------------


def _rows():
    rows = []
    for arm in ("decaph", "fl"):
        for h in (3, 5, 10, 20):
            for seed in (0, 1):
                spec = sc.ScenarioSpec(name=f"s/arm={arm},h={h},seed={seed}",
                                       arm=arm, hospitals=h, seed=seed)
                rows.append(_fake_result(
                    spec, wall_clock=0.3 * h ** 1.2 + 0.01 * seed,
                    bytes_on_wire=1000.0 * h + seed,
                    epsilon=1.5 + 0.1 * seed, noise_topups=seed))
    rows.append({"name": "foreign", "arm": "x"})  # passes through
    return rows


@pytest.mark.parametrize("fn", ["aggregate_seeds", "scaling_laws",
                                "markdown_report"])
def test_report_layer_is_the_references(fn):
    rows = _rows()
    if fn == "markdown_report":
        rows = rows[:-1]
        assert report.markdown_report("s", rows) == \
            jreport.markdown_report("s", rows)
    else:
        assert getattr(report, fn)(rows) == getattr(jreport, fn)(rows)
    fit = report.fit_power_law([3, 5, 10, 20], [2.0 * x ** 1.5
                                                for x in (3, 5, 10, 20)])
    assert fit == jreport.fit_power_law([3, 5, 10, 20],
                                        [2.0 * x ** 1.5
                                         for x in (3, 5, 10, 20)])
    assert fit["exponent"] == pytest.approx(1.5, abs=1e-9)
    assert report.fit_power_law([3, 3], [1.0, 2.0]) is None


def test_write_artifacts(tmp_path):
    rows = _rows()[:-1]
    out_json, out_md = report.write_artifacts("s", rows, tmp_path / "a.json")
    payload = json.loads(out_json.read_text())
    jpayload = jreport.bench_payload("s", rows)
    assert payload["generated_by"] == "python -m repro_torch.scenarios"
    assert {k: v for k, v in payload.items() if k != "generated_by"} == \
        json.loads(json.dumps({k: v for k, v in jpayload.items()
                               if k != "generated_by"}))
    assert out_md.read_text() == jreport.markdown_report("s", rows)


# -- the CLI -----------------------------------------------------------------


def test_cli_list_is_the_references(capsys):
    assert cli.main(["--list"]) == 0
    ours = capsys.readouterr().out.splitlines()
    assert jcli.main(["--list"]) == 0
    ref = capsys.readouterr().out.splitlines()
    # backend-matrix's backend axis holds shard, as the reference's does
    assert ours == ref
    assert any(line.split()[0] == "backend-matrix" and "backendx4" in line
               for line in ours if line.split())


def test_cli_run_writes_torch_artifacts_and_caches(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    args = ["--run", "gemini-small", "--arm", "fl", "--device", "cpu"]
    assert cli.main(args) == 0
    out = capsys.readouterr()
    assert "1 cached, 0 ran" not in out.err
    assert (tmp_path / "BENCH_torch_run.json").exists()
    assert (tmp_path / "BENCH_torch_run.md").exists()
    assert not (tmp_path / "BENCH_run.json").exists()
    assert len(list((tmp_path / ".sweep_cache_torch").glob("*.json"))) == 1
    assert cli.main(args + ["--assert-cached"]) == 0
    assert "(1 cached, 0 ran)" in capsys.readouterr().err
    cell, = json.loads((tmp_path / "BENCH_torch_run.json").read_text())[
        "cells"]
    assert cell["name"] == "gemini-small/arm=fl"
    assert cell["rounds_completed"] == 12 and cell["wall_clock"] > 0


def test_cli_needs_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--run", "gemini-small", "--cache-dir",
                  str(tmp_path / "c"), "--out", str(tmp_path / "r.json")])


@pytest.mark.parametrize("device,jobs", [
    ("cuda", [1]), ("cuda:0", [1]), ("cpu", [min(4, os.cpu_count() or 1)]),
    ("cpu", None)])
def test_cli_sweeps_inline_on_the_card(monkeypatch, tmp_path, device, jobs):
    """``--jobs`` defaults to 1 on a cuda device (one context on the card)
    and to the pool on the cpu; an explicit ``--jobs`` wins."""
    seen = []

    def fake_run_sweep(specs, cache, *, jobs, **kw):
        seen.append(jobs)
        raise SystemExit(0)

    monkeypatch.setattr(cli, "run_sweep", fake_run_sweep)
    args = ["--sweep", "smoke-2x2", "--device", device, "--cache-dir",
            str(tmp_path / "c"), "--out", str(tmp_path / "s.json")]
    with pytest.raises(SystemExit):
        cli.main(args + ([] if jobs else ["--jobs", "3"]))
    assert seen == (jobs or [3])

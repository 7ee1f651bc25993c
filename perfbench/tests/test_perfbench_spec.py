"""Every cell of BENCHMARK.json finds its parts by name, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from perfbench.harness import spec

BENCH = spec.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|head_dim|n_heads|"
                    r"n_kv_heads|hidden|intermediate)")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_every_part_by_name(cell):
    entry = spec.workload(BENCH, cell)
    mc = spec.config(entry["config"])
    mix = spec.traffic(entry["traffic"])
    assert mc["name"] == entry["config"]
    driver = spec.driver(mix["kind"])
    reference = spec.reference(mix["kind"])
    assert callable(driver.run)
    assert reference.__name__.endswith(mix["kind"])
    limits = spec.limits(cell)
    assert limits and all(isinstance(v, float) for v in limits.values())
    reported = spec.per_layer(BENCH, cell)
    assert reported, "every cell reports a per-layer metric"
    for metric in reported:
        assert callable(spec.metric_reader(metric["name"]).read)
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(c["chips"] == 1 for c in BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in CELLS
            assert m["moves"] in {x["name"] for x in
                                  spec.end_to_end(BENCH, cell)}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cuts(entry):
    assert entry["file"].startswith("perfbench/configs/")
    mc = json.loads((spec.ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) <= set(mc["changed"])
    assert set(mc["changed"]) <= set(mc)
    assert not [k for k in entry["reduced"] if WIDTHS.search(k)]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_a_new_part_is_found_by_its_name(tmp_path, monkeypatch):
    """A configuration, mix and metric added as files are found with no
    edit of the harness."""
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "new-model.json").write_text('{"d_model": 8}')
    (tmp_path / "traffic" / "new-mix.json").write_text('{"kind": "eval"}')
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx):\n    return ctx['x']\n")
    assert spec.config("new-model") == {"d_model": 8}
    assert spec.traffic("new-mix")["kind"] == "eval"
    assert spec.metric_reader("new_metric.x").read({"x": 3}) == 3

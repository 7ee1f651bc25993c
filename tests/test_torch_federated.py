"""The ``shard`` backend (``repro_torch.launch.federated``) on CPU ranks.

Every rank is a subprocess (``repro_torch.launch.ranks.spawn``) joining a
``gloo`` group by ``init_method="file://<tmp_path>/..."`` with one thread,
and runs ``tests/_torch_shard_ranks.py``: the reference's two scripts of
``tests/test_backends.py`` at their sizes, ``shard`` against the port's
``ideal``.  Held: every fused-capable arm on ``linear_model(8)`` over 2
ranks (within 1e-5, ε identical, ``sharded_puts > 0``); the three pod-mesh
cells on (2, 2, 2) with the reference's counter assertions; the
participant split bit for bit (``decaph`` on SmolLM and tabular, FedProx's
weighted average); the example split with a model axis within 1e-5; the
noise of the example split at σ = 4 (its variance is (Cσ)², not twice
that); decaph at σ = 0 against the *reference's* ``ideal`` within 1e-5.
The capability record is the reference's field for field but for
``device_requirements``' text.
"""

import dataclasses
import json
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import repro.arms as jarms
import repro_torch.arms as arms
from repro.arms import backends as jbackends
from repro.core.dp import DPConfig as JDPConfig
from repro.data.synthetic import make_gemini_like as jmake_gemini_like
from repro.models.tabular import linear_model as jlinear_model
from repro_torch.arms import backends
from repro_torch.launch.ranks import spawn

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
ATOL = 1e-5


CELLS = {"arms": 2, "pod": 8, "splits": 4}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Every cell's report; the three groups of ranks run at once."""
    tmp = tmp_path_factory.mktemp("shard")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def one(cell):
        return spawn([sys.executable,
                      os.path.join(HERE, "_torch_shard_ranks.py"), cell],
                     CELLS[cell], str(tmp / f"init_{cell}"), timeout=300,
                     env=env)

    with ThreadPoolExecutor(len(CELLS)) as pool:
        done = dict(zip(CELLS, pool.map(one, CELLS)))
    return done


def _run(cell: str, reports) -> dict:
    procs = reports[cell]
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (rank, p.stderr[-4000:])
    line = [ln for ln in procs[0].stdout.splitlines()
            if ln.startswith("RESULT::")][0]
    return json.loads(line[len("RESULT::"):])


def test_backend_info_is_the_references():
    ours = dataclasses.asdict(backends.backend_registry()["shard"])
    ref = dataclasses.asdict(jbackends.backend_registry()["shard"])
    assert ours.pop("device_requirements") and ref.pop("device_requirements")
    assert ours == ref
    assert backends.bit_exact_groups()["spmd"] == ("shard",)


def test_every_fused_arm_matches_ideal_on_two_ranks(reports):
    report = _run("arms", reports)
    assert {"decaph", "fl", "fedprox", "scaffold", "primia"} <= set(
        report["arms"])
    for name, cell in report["cells"].items():
        assert cell["rounds"][0] == cell["rounds"][1], name
        assert cell["max_abs_diff"] <= ATOL, (name, cell)
        assert cell["epsilon"][0] == cell["epsilon"][1], name
        assert cell["sharded_puts"] > 0, name        # SPMD actually engaged
        assert cell["participant_shards"] == 0, name  # 1-D mesh: examples
        assert cell["collective_bytes"]["all_reduce"] > 0, name
        assert cell["backend_label"] == "shard"
    # each slot's noise share is added once, after the all-reduce: per-rank
    # shares would double the variance on 2 ranks
    ratio = report["noise_var"] / report["noise_target"]
    assert 0.85 < ratio < 1.15, report["noise_var"]
    # sigma 0: the reference's ideal backend, within 1e-5
    silos = jarms.normalize_participants(
        jmake_gemini_like(seed=0, n_total=720, n_silos=5, n_features=8))
    ref = jarms.run("decaph", jlinear_model(8), silos, jarms.ArmConfig(
        rounds=3, batch_size=48, lr=0.3, seed=0, use_secagg=False,
        dp=JDPConfig(clip_norm=1.0, noise_multiplier=0.0,
                     microbatch_size=8)))
    for key, value in report["sigma0"].items():
        np.testing.assert_allclose(np.asarray(value, np.float32),
                                   np.asarray(ref.params[key]), rtol=0,
                                   atol=ATOL)
    assert report["sigma0_eps"] == float(ref.epsilon) == math.inf


def test_pod_mesh_cells_match_ideal(reports):
    """("pod", "data", "model") cells: the hospital axis splits over
    ("pod", "data") and model-parallel params over ("model",) for the
    transformer; the tabular cell rides the same mesh replicated."""
    report = _run("pod", reports)
    assert set(report) == {"decaph-lm-ghost", "decaph-lm-faithful",
                           "decaph-tabular"}
    for label, cell in report.items():
        assert cell["rounds"][0] == cell["rounds"][1], label
        assert cell["max_abs_diff"] <= ATOL, (label, cell)
        assert cell["epsilon"][0] == cell["epsilon"][1], label
        assert cell["sharded_puts"] > 0, label
        assert cell["participant_shards"] > 0, label  # pods own cohort slices
        assert cell["backend_label"] == "shard", label
        if label.startswith("decaph-lm"):
            assert cell["param_shards"] > 0, label    # TP over ("model",)
        else:
            assert cell["param_shards"] == 0, label   # tabular: replicated


def test_participant_and_example_splits(reports):
    report = _run("splits", reports)
    for label in ("participant-lm", "participant-tabular",
                  "participant-fedavg"):
        cell = report[label]
        # each rank's slots, all-gathered and folded in slot order: ideal's
        # numbers exactly, losses too
        assert cell["max_abs_diff"] == 0.0, (label, cell)
        assert cell["losses"][0] == cell["losses"][1] or label.endswith(
            "fedavg"), label
        assert cell["epsilon"][0] == cell["epsilon"][1], label
        assert cell["participant_shards"] > 0 and cell["param_shards"] == 0
        assert cell["collective_bytes"]["all_gather"] > 0, label
    # the kernel wrapper on DTensors: a feature split of either operand is
    # summed over the model ranks; of both, refused
    ghost = report["ghost_norm"]
    assert ghost["g-columns"] <= 1e-4 and ghost["a-columns"] <= 1e-4, ghost
    assert "does not split" in ghost["both"], ghost
    cell = report["example-model-lm"]
    assert cell["max_abs_diff"] <= ATOL, cell
    assert cell["epsilon"][0] == cell["epsilon"][1]
    assert cell["participant_shards"] == 0 and cell["param_shards"] > 0
    assert cell["collective_bytes"]["all_reduce"] > 0

"""``repro_torch.population`` (the trace-then-solve backend) against
``repro.population``.

The trace phase is host arithmetic: the port's ``PopulationSpec`` builds
the reference's node and topology dicts, its ``CohortSampler`` draws the
reference's cohorts, and its ``run_trace`` emits the reference's compute
graph byte for byte (``to_json_bytes()``, ``graph_hash()``) with every
``Trace`` field equal — for ``fl`` (the server facilitates) at the
defaults, and for ``decaph`` under ``round_robin`` leaders: under
``uniform`` DeCaPH's leader draw is the port's own numpy draw (ROADMAP.md,
Queue 3), and the facilitator decides where uploads go.

The solve phase: at q = 1 the port's ``population`` equals its ``ideal``
bit for bit (the reference's own contract, ``tests/test_population.py``);
at q = 0.5 against the reference's ``population``, the parameters agree
within 1e-5 at sigma 0 (also with an upload dropped mid-round, the device
payload path), the ``SolveReport`` is field-equal but for its host
seconds, and at sigma 0.8 ε and the privacy ledger are bit-identical.
Models: the zero-initialised logistic regression, the same in both
packages, on the reference's ``_silos`` data.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro.obs as jobs
import repro.population as jpop
import repro.sim as jsim
from repro.arms import backends as jbackends
from repro.core.dp import DPConfig as JDPConfig
from repro.models import tabular as jtab
from repro.population.backend import PopulationRunner as JRunner
from repro.population.cli import main as jcli
from repro.population.trace import run_trace as jrun_trace
import repro_torch.arms as arms
import repro_torch.obs as obs
import repro_torch.population as pop
import repro_torch.sim as sim
from repro_torch.arms import backends
from repro_torch.core import dp as dp_lib
from repro_torch.models.tabular import linear_model
from repro_torch.population import solve as solve_lib
from repro_torch.population.backend import PopulationRunner
from repro_torch.population.cli import main as cli
from repro_torch.population.trace import run_trace

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parent.parent / "src"
ATOL = 1e-5


# -- shared set-up: the reference's _silos / _cfg, in both packages ----------


def _silos(mod, sizes, d=5, seed=0):
    rng = np.random.default_rng(seed)
    w_true = np.array([1.5, -2.0, 1.0, 0.0, 0.5])[:d]
    out = []
    for i, n in enumerate(sizes):
        x = rng.normal(0.1 * i, 1.0, (n, d)).astype(np.float32)
        y = (x @ w_true + rng.normal(0, 0.2, n) > 0).astype(np.float32)
        out.append(mod.Participant(x, y))
    return out


def _cfg(port: bool, sigma=0.7, **kw):
    mod, dpc = (arms, dp_lib.DPConfig) if port else (jarms, JDPConfig)
    base = dict(rounds=5, batch_size=32, lr=0.3, seed=0, use_secagg=False,
                dp=dpc(clip_norm=1.0, noise_multiplier=sigma,
                       microbatch_size=8))
    base.update(kw)
    return mod.ArmConfig(**base)


def _arm(port: bool, name: str, sizes, sigma=0.7, **kw):
    mod = arms if port else jarms
    model = (linear_model(5, device="cpu") if port
             else jtab.linear_model(5))
    return mod.get(name)(model, _silos(mod, sizes), _cfg(port, sigma, **kw))


def _trace_fields(tr) -> dict:
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)
            if f.name != "graph"}


def _assert_traces_equal(ours, ref):
    assert ours.graph.to_json_bytes() == ref.graph.to_json_bytes()
    assert ours.graph.graph_hash() == ref.graph.graph_hash()
    a, b = _trace_fields(ours), _trace_fields(ref)
    a["rounds"] = [dataclasses.asdict(p) for p in a["rounds"]]
    b["rounds"] = [dataclasses.asdict(p) for p in b["rounds"]]
    assert a == b


def _leaves_equal(a, b) -> bool:
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                   tree_leaves(b)))


def _max_diff(params, jparams) -> float:
    return max(float(np.max(np.abs(params[k].numpy() - np.asarray(jparams[k]))))
               for k in ("w", "b"))


# -- PopulationSpec ----------------------------------------------------------


def test_population_spec_roundtrip():
    spec = pop.PopulationSpec(hospitals=64, seed=3, topology="small_world",
                              degree=6, flaky_fraction=0.1)
    assert pop.PopulationSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == jpop.PopulationSpec(
        hospitals=64, seed=3, topology="small_world", degree=6,
        flaky_fraction=0.1).to_dict()
    assert spec.replace(seed=4).seed == 4


BAD_SPECS = [
    {"hospitals": 1},
    {"hospitals": 8, "topology": "torus"},
    {"hospitals": 8, "degree": 8},
    {"hospitals": 8, "degree": 1, "topology": "small_world"},
    {"hospitals": 8, "rewire_p": 1.5},
    {"hospitals": 8, "flaky_fraction": -0.1},
    {"hospitals": 8, "latency": -1.0},
    {"hospitals": 8, "bandwidth": 0.0},
    {"hospitals": 8, "bogus_knob": 1},
]


@pytest.mark.parametrize("bad", BAD_SPECS, ids=lambda d: ",".join(d))
def test_population_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as ref:
        jpop.PopulationSpec.from_dict(bad)
    with pytest.raises(ValueError) as ours:
        pop.PopulationSpec.from_dict(bad)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("topology", ["k_regular", "small_world", "star",
                                      "ring", "full"])
@pytest.mark.parametrize("hospitals", [50, 200])
def test_build_nodes_and_topology_are_the_references(hospitals, topology):
    kw = dict(hospitals=hospitals, seed=7, topology=topology, degree=6,
              flaky_fraction=0.2, mean_uptime=30.0, mean_downtime=5.0,
              churn_rate=0.02, horizon=600.0)
    ours, ref = pop.PopulationSpec(**kw), jpop.PopulationSpec(**kw)
    assert ours.build_nodes() == ref.build_nodes()
    assert ours.build_topology() == ref.build_topology()
    assert ours.build_topology_static() == ref.build_topology_static()


# -- CohortSampler -----------------------------------------------------------


@pytest.mark.parametrize("q", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cohorts_are_the_references(seed, q):
    ours = pop.CohortSampler(h=200, q=q, seed=seed)
    ref = jpop.CohortSampler(h=200, q=q, seed=seed)
    for t in range(21):
        assert ours.cohort(t) == ref.cohort(t)
    assert ours.empirical_rate() == ref.empirical_rate()
    assert pop.CohortSampler(h=8, q=1.0, seed=seed).cohort(3) == \
        list(range(8))
    with pytest.raises(ValueError, match="participation rate"):
        pop.CohortSampler(h=8, q=0.0, seed=seed)


# -- the trace phase ---------------------------------------------------------


def _population(port: bool, h: int, topology: str, seed=11):
    mod = pop if port else jpop
    simmod = sim if port else jsim
    spec = mod.PopulationSpec(hospitals=h, seed=seed, topology=topology,
                              degree=6, flaky_fraction=0.2, mean_uptime=30.0,
                              mean_downtime=5.0, churn_rate=0.01)
    return (simmod.nodes_from_trace(spec.build_nodes()),
            simmod.Topology.from_trace(spec.build_topology()))


@pytest.mark.parametrize("secure", [True, False], ids=["secure", "plain"])
@pytest.mark.parametrize("topology", ["k_regular", "small_world"])
def test_run_trace_is_byte_identical_to_the_references(topology, secure):
    """The reference's churny trace (a small world of 50 with 20% flaky
    hospitals and link churn) through both packages' ``run_trace``."""
    traces = []
    for port, fn in ((True, run_trace), (False, jrun_trace)):
        nodes, topo = _population(port, 50, topology)
        traces.append(fn(
            nodes, topo, rounds=6, q=0.3, seed=11, sizes=[32] * 50,
            model_bytes=4096, secure=secure, quorum=3, require=None,
            facilitator=lambda t, cohort: cohort[t % len(cohort)],
            eval_every=2))
    _assert_traces_equal(*traces)
    assert traces[0].graph.graph_hash() == run_trace(
        *_population(True, 50, topology), rounds=6, q=0.3, seed=11,
        sizes=[32] * 50, model_bytes=4096, secure=secure, quorum=3,
        require=None, facilitator=lambda t, c: c[t % len(c)],
        eval_every=2).graph.graph_hash()


ARM_TRACES = [("fl", {}), ("fl", {"fl_local_steps": 3}), ("fedprox", {}),
              ("scaffold", {}), ("primia", {}),
              ("decaph", {"leader_strategy": "round_robin"})]


@pytest.mark.parametrize("case", ARM_TRACES,
                         ids=["fl", "fedavg", "fedprox", "scaffold", "primia",
                              "decaph-round_robin"])
@pytest.mark.parametrize("topology", ["k_regular", "small_world"])
def test_runner_trace_matches_the_references(case, topology):
    """``PopulationRunner.trace`` on an arm built directly, at H = 50 with
    flaky hospitals and link churn, q 0.3: the graph, every round plan and
    every counter are the reference's."""
    name, kw = case
    sizes = (60,) * 50
    traces = []
    for port, runner in ((True, PopulationRunner), (False, JRunner)):
        nodes, topo = _population(port, 50, topology)
        arm = _arm(port, name, sizes, participation_rate=0.3, **kw)
        traces.append(runner(nodes, topo).trace(arm))
    _assert_traces_equal(*traces)
    assert any(not p.lost for p in traces[0].rounds)


@pytest.mark.parametrize("name", ["decaph", "fl", "primia"])
def test_retrace_is_byte_identical(name):
    """The port's own determinism for every arm: a re-trace with fresh
    nodes and topology gives the same bytes (decaph at its uniform
    leaders, which are the port's own draw)."""
    arm = _arm(True, name, (60,) * 50, participation_rate=0.3)
    blobs = {PopulationRunner(*_population(True, 50, "small_world"))
             .trace(arm).graph.to_json_bytes() for _ in range(2)}
    assert len(blobs) == 1
    graph = pop.ComputeGraph.from_json_bytes(blobs.pop())
    payload = json.loads(graph.to_json_bytes())
    payload["nodes"][0]["t_end"] += 1.0
    with pytest.raises(ValueError, match="content hash"):
        pop.ComputeGraph.from_json_bytes(json.dumps(payload).encode())


# -- the solve phase ---------------------------------------------------------


@pytest.mark.parametrize("name", ["decaph", "fl", "fedprox", "scaffold",
                                  "primia"])
def test_population_matches_ideal_bit_for_bit_at_q1(name):
    """Under full participation and an ideal trace ``population`` consumes
    the rng as ``ideal`` does, and its sums are the same folds."""
    model = linear_model(5, device="cpu")
    silos = _silos(arms, (120,) * 4)
    cfg = _cfg(True)
    kind = arms.get(name).topology_kind
    topo = sim.Topology.star(4, 0) if kind == "star" else sim.Topology.full(4)
    ref = arms.run(name, model, silos, cfg, backend="ideal")
    ours = arms.run(name, model, silos, cfg, backend="population", topo=topo)
    assert ours.rounds_completed == ref.rounds_completed == 5
    assert ours.epsilon == ref.epsilon
    assert [l.loss for l in ours.logs] == [l.loss for l in ref.logs] or \
        all(np.isnan(l.loss) for l in ours.logs + ref.logs)
    assert _leaves_equal(ours.params, ref.params)
    assert ours.timing is not None and ours.timing.wall_clock > 0


def _pop_runs(name, sigma, *, nodes_trace=None, **kw):
    """One run per package on ``population`` at q 0.5, 6 hospitals; the
    port's and the reference's runner (for ``last_solve``)."""
    out = []
    for port, runner_cls in ((True, PopulationRunner), (False, JRunner)):
        simmod = sim if port else jsim
        arm = _arm(port, name, (120,) * 6, sigma, participation_rate=0.5,
                   rounds=6, **kw)
        nodes = (simmod.nodes_from_trace(nodes_trace)
                 if nodes_trace is not None else None)
        runner = runner_cls(nodes, simmod.Topology.full(6))
        out.append((runner.run(arm), runner))
    return out


def _solve_fields(report) -> dict:
    d = dataclasses.asdict(report)
    del d["wall_seconds"]
    return d




def _drop_trace(i: int, t_off: float) -> list[dict]:
    """Six uniform hospitals; hospital ``i`` drops out at ``t_off``
    simulated seconds and never rejoins."""
    trace = [{"throughput": 400.0, "overhead": 0.02} for _ in range(6)]
    trace[i]["dropouts"] = [[t_off, None]]
    return trace


# inside decaph's round 3 under round_robin leaders (cohort 0-5 from
# 0.2175 s, facilitator 3), and inside fl's round 1 (cohort 0, 1, 5 from
# 0.14 s): one upload lost mid-round each
DROP_TRACE = _drop_trace(2, 0.23)
FL_DROP_TRACE = _drop_trace(5, 0.2)

SOLVE_CASES = [("fl", {}, None), ("fl", {"fl_local_steps": 3}, None),
               ("decaph", {"leader_strategy": "round_robin"}, None),
               ("decaph", {"leader_strategy": "round_robin"}, DROP_TRACE),
               ("fl", {}, FL_DROP_TRACE)]


@pytest.mark.parametrize(
    "case", SOLVE_CASES,
    ids=["fl", "fedavg", "decaph", "decaph-dropout", "fl-dropout"])
def test_sigma0_solve_matches_reference(case):
    name, kw, trace = case
    (ours, runner), (ref, jrunner) = _pop_runs(name, 0.0, nodes_trace=trace,
                                               **kw)
    assert ours.rounds_completed == ref.rounds_completed >= 1
    assert _max_diff(ours.params, ref.params) <= ATOL
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=ATOL)
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    assert _solve_fields(runner.last_solve) == \
        _solve_fields(jrunner.last_solve)
    assert dataclasses.asdict(ours.timing) == dataclasses.asdict(ref.timing)
    if trace is not None:
        assert sum(len(p.dropped) for p in runner.last_trace.rounds) == 1
        assert ours.timing.noise_topups == (name == "decaph")


def test_epsilon_and_ledger_are_bit_identical():
    """ε never depends on the draws: at sigma 0.8 and q 0.5 every ledger
    entry (cohorts, deliveries, ε at rate·q) is the reference's."""
    with obs.recording() as rec, jobs.recording() as jrec:
        (ours, _), (ref, _) = _pop_runs(
            "decaph", 0.8, leader_strategy="round_robin")
        rows, jrows = rec.ledger.entries(), jrec.ledger.entries()
    assert rows and rows == jrows
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]
    arm = _arm(True, "decaph", (120,) * 6, 0.8, participation_rate=0.5)
    assert arm.acct.sampling_rate == arm.rate * 0.5


def test_eval_nodes_run_the_probe_loss():
    (ours, runner), (ref, jrunner) = _pop_runs("fl", 0.0, eval_every=2)
    evals, jevals = runner.last_solve.evals, jrunner.last_solve.evals
    assert [t for t, _ in evals] == [t for t, _ in jevals] and evals
    np.testing.assert_allclose([v for _, v in evals], [v for _, v in jevals],
                               rtol=ATOL)


def test_dropout_topup_has_the_calibrated_variance(monkeypatch):
    """A DeCaPH upload lost mid-round: the solve tops the delivered sum up
    with N(0, (C sigma)^2 m / n) for the m of n shares lost, drawn from
    ``noise_seed(seed * 31 + TOPUP_STREAM, t)``; drawn on a 200,000-leaf
    template, its standard deviation is within 1% of C sigma sqrt(m / n)."""
    calls = []
    real = dp_lib.tree_topup_noise

    def recording(template, gen, **kw):
        calls.append((gen.initial_seed(), kw))
        return real(template, gen, **kw)

    monkeypatch.setattr(solve_lib.dp_lib, "tree_topup_noise", recording)
    (ours, runner), _ = _pop_runs("decaph", 0.8, nodes_trace=DROP_TRACE,
                                  leader_strategy="round_robin")
    plans = runner.last_trace.rounds
    dropped = [p for p in plans if p.dropped and not p.lost]
    assert calls and len(calls) == len(dropped) == ours.timing.noise_topups
    for (seed, kw), plan in zip(calls, dropped):
        assert seed == dp_lib.noise_seed(0 * 31 + dp_lib.TOPUP_STREAM,
                                         plan.t)
        assert kw["missing"] == len(plan.dropped)
        assert kw["n_shares"] == len(plan.cohort)
        gen = torch.Generator().manual_seed(seed)
        big = real({"w": torch.zeros(200_000)}, gen, **kw)["w"]
        want = kw["clip_norm"] * kw["noise_multiplier"] * np.sqrt(
            kw["missing"] / kw["n_shares"])
        assert abs(float(big.std()) / want - 1) < 0.01


# -- registry and capability gates ------------------------------------------


def test_backend_info_is_the_references():
    ours = backends.backend_registry()["population"]
    ref = jbackends.backend_registry()["population"]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert backends.backend_names() == ("ideal", "population", "shard",
                                        "sim")


@pytest.mark.parametrize("backend", ["ideal", "sim"])
def test_subsampling_refused_without_capability(backend):
    cfg = _cfg(True, participation_rate=0.5)
    err = backends.compatibility_error(
        arms.get("decaph"), backends.backend_registry()[backend],
        use_secagg=False, participation_rate=0.5)
    ref = jbackends.compatibility_error(
        jarms.get("decaph"), jbackends.backend_registry()[backend],
        use_secagg=False, participation_rate=0.5)
    assert err == ref and "participation_rate" in err
    nodes = (sim.nodes_from_trace(sim.heterogeneous_trace(4))
             if backend == "sim" else None)
    with pytest.raises(ValueError, match="participation_rate"):
        arms.run("decaph", linear_model(5, device="cpu"),
                 _silos(arms, (120,) * 4), cfg, backend=backend, nodes=nodes)


@pytest.mark.parametrize("case", [("gossip", {}), ("decaph",
                                                   {"use_secagg": True}),
                                  ("fl", {"fused_rounds": False})],
                         ids=["node-arm", "secagg", "unfused"])
def test_population_refuses_what_it_cannot_run(case):
    name, kw = case
    cfg, jcfg = _cfg(True, **kw), _cfg(False, **kw)
    err = backends.compatibility_error(
        arms.get(name), backends.backend_registry()["population"],
        use_secagg=cfg.use_secagg, fused_rounds=cfg.fused_rounds)
    assert err == jbackends.compatibility_error(
        jarms.get(name), jbackends.backend_registry()["population"],
        use_secagg=jcfg.use_secagg, fused_rounds=jcfg.fused_rounds)
    with pytest.raises(ValueError, match="population"):
        arms.run(name, linear_model(5, device="cpu"),
                 _silos(arms, (120,) * 4), cfg, backend="population")


# -- the CLI -----------------------------------------------------------------


def test_cli_matches_reference_and_checks_determinism(tmp_path):
    argv = ["--hospitals", "50", "--seeds", "0", "--arms", "fl", "--rounds",
            "2", "--check-determinism"]
    assert cli(argv + ["--device", "cpu", "--out",
                       str(tmp_path / "ours.json")]) == 0
    assert jcli(argv + ["--out", str(tmp_path / "ref.json")]) == 0
    ours = json.loads((tmp_path / "ours.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert ours["generated_by"] == "python -m repro_torch.population"
    assert (tmp_path / "ours.md").exists()
    (a,), (b,) = ours["cells"], ref["cells"]
    assert a["determinism_checked"] and b["determinism_checked"]
    for key in ("name", "graph_hash", "graph_nodes", "empirical_q",
                "mean_cohort", "wall_clock", "bytes_on_wire",
                "rounds_completed", "epsilon", "lost_rounds",
                "dropout_events", "model_params"):
        assert a[key] == b[key], key


def test_cli_needs_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["--hospitals", "50", "--seeds", "0", "--arms", "fl",
             "--rounds", "1", "--out", str(tmp_path / "x.json")])


def test_trace_modules_load_no_torch_jax_or_reference():
    """Importing the population and scenarios packages loads neither JAX
    nor the reference; their trace-phase, spec, cache, grid and report
    modules also load no torch."""
    code = (
        "import sys\n"
        "import repro_torch.population.spec, repro_torch.population.sampler\n"
        "import repro_torch.population.graph, repro_torch.population.trace\n"
        "import repro_torch.scenarios.spec, repro_torch.scenarios.cache\n"
        "import repro_torch.scenarios.report, repro_torch.scenarios.grid\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('torch', 'jax', 'repro')]\n"
        "import repro_torch.population, repro_torch.scenarios\n"
        "import repro_torch.population.backend, repro_torch.population.cli\n"
        "import repro_torch.scenarios.executor, repro_torch.scenarios.cli\n"
        "bad += [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr

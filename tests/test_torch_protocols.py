"""``repro_torch.sim.protocols`` (the deprecated ``simulate_*`` shims,
``SimConfig``, ``ArmReport`` and ``scenario_from_trace``) against
``repro.sim.protocols``, on the CPU.

Each shim runs the GEMINI-like MLP of ``_torch_gemini`` (the reference's
weights, sigma = 0) on the same scenario in both packages: every
``SimTiming`` field is equal and the parameters agree within 1e-5.  The
leaders rotate (``round_robin``): DeCaPH's uniform draw is the port's own
numpy draw, which moves its uploads to other links (ROADMAP.md, Queue 3).
The legacy properties of ``RunReport`` read its ``timing`` section.
"""

import dataclasses
import warnings

import pytest
import torch

import repro.sim as jsim
import repro.sim.protocols as jproto
import repro_torch.arms as arms
import repro_torch.sim as sim
import repro_torch.sim.protocols as proto

from _torch_gemini import DROPOUT, H, cfg, make_setup, max_diff

torch.set_num_threads(1)

ATOL = 1e-5
LEGACY = ("wall_clock", "bytes_on_wire", "dropout_events", "recoveries",
          "lost_rounds", "events", "noise_topups")


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _scenario(dropout=None, topology=None):
    """``heterogeneous_trace(H)`` as a scenario dict, hospital i off from
    t_off to t_on if ``dropout = (i, t_off, t_on)`` is given."""
    nodes = sim.heterogeneous_trace(H)
    if dropout is not None:
        i, t_off, t_on = dropout
        nodes[i] = dict(nodes[i], dropouts=[[t_off, t_on]])
    return {"nodes": nodes, "topology": topology or {"kind": "full"}}


def _quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args)


def test_module_surface_is_the_references():
    assert proto.__all__ == jproto.__all__
    assert list(proto.SIM_RUNNERS) == list(jproto.SIM_RUNNERS)
    for name in proto.__all__:
        assert getattr(sim, name) is getattr(proto, name)
    assert proto.ArmReport is arms.RunReport
    assert proto.SIM_RUNNERS["gossip-dp"].__name__ == "simulate_gossip_dp"


def test_sim_config_keeps_the_historical_twenty_rounds():
    assert proto.SimConfig().rounds == jproto.SimConfig().rounds == 20
    assert arms.ArmConfig().rounds == 100
    assert issubclass(proto.SimConfig, arms.ArmConfig)
    ours = {f.name: f.default for f in dataclasses.fields(proto.SimConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jproto.SimConfig)}
    assert ours.keys() == ref.keys()
    assert {k: v for k, v in ours.items() if k != "dp"} == \
        {k: v for k, v in ref.items() if k != "dp"}


@pytest.mark.parametrize("topology", [
    None, {"kind": "ring"},
    {"kind": "k_regular", "k": 2,
     "default": {"bandwidth": 2e6, "latency": 0.01},
     "links": {"0-1": {"bandwidth": 1e5, "latency": 0.3}},
     "schedule": [{"t": 1.0, "link": "0-1", "down": True}]},
], ids=["full", "ring", "k-regular-churn"])
def test_scenario_from_trace_builds_the_references(topology):
    tr = _scenario(DROPOUT, topology)
    nodes, topo = proto.scenario_from_trace(tr)
    jnodes, jtopo = jproto.scenario_from_trace(tr)
    assert [dataclasses.asdict(n) for n in nodes] == \
        [dataclasses.asdict(n) for n in jnodes]
    assert (topo.name, topo.n) == (jtopo.name, jtopo.n) == (topo.name, H)
    for t in (0.0, 1.5):
        assert topo.advance_to(t) == jtopo.advance_to(t)
        for i in range(H):
            assert topo.neighbors(i) == jtopo.neighbors(i)
            for j in topo.neighbors(i):
                assert topo.transfer_time(i, j, 1e6) == \
                    jtopo.transfer_time(i, j, 1e6)


@pytest.mark.parametrize("name", sorted(proto.SIM_RUNNERS))
def test_simulate_matches_reference(setup, name):
    kw = dict(leader_strategy="round_robin")
    nodes, topo = proto.scenario_from_trace(_scenario(DROPOUT))
    jnodes, jtopo = jproto.scenario_from_trace(_scenario(DROPOUT))
    ours = _quiet(proto.SIM_RUNNERS[name], setup["tmodel"], setup["tsilos"],
                  nodes, topo, cfg(**kw))
    ref = _quiet(jproto.SIM_RUNNERS[name], setup["jmodel"], setup["jsilos"],
                 jnodes, jtopo, cfg(port=False, **kw))
    assert ours.backend == ref.backend == "sim" and ours.arm == name
    assert dataclasses.asdict(ours.timing) == dataclasses.asdict(ref.timing)
    for prop in LEGACY:
        assert getattr(ours, prop) == getattr(ref, prop) == \
            getattr(ours.timing, prop)
    assert ours.rounds_completed == ref.rounds_completed
    assert [(l.round, l.leader, l.aggregate_batch) for l in ours.logs] == \
        [(l.round, l.leader, l.aggregate_batch) for l in ref.logs]
    assert max_diff(ours.params, ref.params) <= ATOL
    for a, b in zip(ours.per_client_params or [],
                    ref.per_client_params or []):
        assert max_diff(a, b) <= ATOL


@pytest.mark.parametrize("name", ["decaph", "gossip-dp"])
def test_simulate_warns_with_the_ports_names(setup, name):
    nodes, topo = proto.scenario_from_trace(_scenario())
    with pytest.warns(DeprecationWarning) as caught:
        proto.SIM_RUNNERS[name](setup["tmodel"], setup["tsilos"], nodes, topo,
                                cfg(rounds=1))
    w, = [w for w in caught if w.category is DeprecationWarning]
    assert str(w.message) == (
        f"repro_torch.sim.protocols.simulate_{name.replace('-', '_')} is "
        f"deprecated; use repro_torch.arms.run({name!r}, ..., "
        "backend='sim', nodes=..., topo=...)")
    assert w.filename == __file__           # stacklevel=2: the caller's line


def test_simulate_decaph_is_arms_run_on_sim_bit_for_bit(setup):
    """Dropout-robust SecAgg, the default uniform leaders, sigma 0.8: the
    shim is ``arms.run(..., backend="sim")`` bit for bit."""
    config = cfg(0.8, use_secagg=True)
    nodes, topo = proto.scenario_from_trace(_scenario(DROPOUT))
    ours = _quiet(proto.simulate_decaph, setup["tmodel"], setup["tsilos"],
                  nodes, topo, config)
    nodes, topo = proto.scenario_from_trace(_scenario(DROPOUT))
    direct = arms.run("decaph", setup["tmodel"], setup["tsilos"], config,
                      backend="sim", nodes=nodes, topo=topo)
    assert ours.timing == direct.timing and ours.recoveries >= 1
    assert ours.epsilon == direct.epsilon
    assert [dataclasses.astuple(l) for l in ours.logs] == \
        [dataclasses.astuple(l) for l in direct.logs]
    for k in ours.params:
        for leaf in ours.params[k]:
            assert torch.equal(ours.params[k][leaf], direct.params[k][leaf])


def test_legacy_properties_read_timing_and_are_zero_without_it():
    timing = arms.SimTiming(wall_clock=1.5, bytes_on_wire=2.0e6,
                            dropout_events=3, recoveries=4, lost_rounds=5,
                            events=6, noise_topups=7)
    report = proto.ArmReport(params={}, logs=[], epsilon=0.0,
                             rounds_completed=0, per_node_params=[{}],
                             timing=timing)
    for prop in LEGACY:
        assert getattr(report, prop) == getattr(timing, prop)
    assert report.per_client_params is report.per_node_params
    ideal = dataclasses.replace(report, timing=None, per_node_params=None)
    assert [getattr(ideal, p) for p in LEGACY] == [0.0, 0.0, 0, 0, 0, 0, 0]
    assert ideal.per_client_params is None
    jideal = jsim.ArmReport(params={}, logs=[], epsilon=0.0,
                            rounds_completed=0)
    assert [getattr(ideal, p) for p in LEGACY] == \
        [getattr(jideal, p) for p in LEGACY]
    assert [type(getattr(ideal, p)) for p in LEGACY] == \
        [type(getattr(jideal, p)) for p in LEGACY]

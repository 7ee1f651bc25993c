"""The port's simulator and its simulated-time backend, on the CPU.

``repro_torch.sim`` (engine, nodes, topology) is host Python copied from
``repro.sim``: events, traces and links are the reference's bit for bit.
``SimRunner`` against the reference's is ``test_torch_sim_runner.py``.

Within the port, ``ideal`` and ``sim`` share the ``bit_exact_group``
"host": under an ideal trace they give the same trajectory bit for bit
for every arm — scaffold included, which the reference's own cell misses
by an ulp (its in-program reduction and its eager one round differently).
"""

import dataclasses
import random
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro_torch.arms as arms
import repro_torch.sim as sim
from repro_torch.arms import backends, fused, runners

from _torch_gemini import H, case_id as _id, cfg, make_setup

torch.set_num_threads(1)

CASES = [("decaph", {}), ("decaph", {"use_secagg": True}), ("fedprox", {}),
         ("fl", {}), ("fl", {"fl_local_steps": 3}), ("gossip", {}),
         ("gossip-dp", {}), ("local", {}), ("primia", {}), ("scaffold", {})]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def trace():
    """``heterogeneous_trace(H)`` as fresh nodes (``online`` is run state)."""
    return sim.nodes_from_trace(sim.heterogeneous_trace(H))


def _events(engine):
    return [(engine.now, type(ev).__name__,
             tuple(sorted(dataclasses.asdict(ev).items())))
            for ev in engine.drain()]


# -- the simulator's host models -------------------------------------------


def test_engine_fires_events_in_the_references_order():
    """Ties at one time fire in scheduling order (the heap's (time, seq));
    cancelled events never fire; pending_kinds and peek_time agree."""
    rnd = random.Random(5)
    engines = (sim.EventEngine(), jsim.EventEngine())
    handles = ([], [])
    for k in range(200):
        t = rnd.choice([0.0, 0.5, 1.0, 1.5, rnd.random() * 3])
        kind = rnd.randrange(4)
        for mod, eng, hs in zip((sim, jsim), engines, handles):
            ev = (mod.ComputeDone(k % 5, tag=f"c{k}", payload=k),
                  mod.TransferDone(k % 5, (k + 1) % 5, 8.0 * k, tag="x"),
                  mod.NodeDropout(k % 5), mod.NodeRejoin(k % 5))[kind]
            hs.append(eng.schedule_at(t, ev))
    for k in rnd.sample(range(200), 40):
        for eng, hs in zip(engines, handles):
            eng.cancel(hs[k])
    ours, ref = engines
    assert len(ours) == len(ref) == 160
    assert {c.__name__ for c in ours.pending_kinds()} == \
        {c.__name__ for c in ref.pending_kinds()}
    assert ours.peek_time() == ref.peek_time()
    assert _events(ours) == _events(ref)
    assert ours.processed == ref.processed == 160
    with pytest.raises(ValueError, match="negative delay"):
        ours.schedule(-1.0, sim.NodeDropout(0))
    with pytest.raises(ValueError, match="past"):
        ours.schedule_at(0.0, sim.NodeDropout(0))


def test_engine_run_stops_where_the_references_does():
    outs = []
    for mod in (sim, jsim):
        eng, seen = mod.EventEngine(), []
        for k in range(10):
            eng.schedule_at(0.3 * k, mod.NodeDropout(k))
        n1 = eng.run(seen.append, until=1.0)
        n2 = eng.run(seen.append, max_events=3)
        outs.append((n1, n2, eng.now, [e.node for e in seen], len(eng)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_traces_and_compute_times_are_the_references(n):
    assert sim.heterogeneous_trace(n) == jsim.heterogeneous_trace(n)
    assert sim.heterogeneous_trace(n, fastest=90.0, slowdown=0.8,
                                   overhead=0.5) == \
        jsim.heterogeneous_trace(n, fastest=90.0, slowdown=0.8, overhead=0.5)
    tr = sim.heterogeneous_trace(n)
    tr[-1] = dict(tr[-1], dropouts=[[1.0, 2.5], [4.0, None]])
    ours, ref = sim.nodes_from_trace(tr), jsim.nodes_from_trace(tr)
    for a, b in zip(ours, ref):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for k in (0, 1, 7, 96, 5801):
            assert a.compute_time(k) == b.compute_time(k)
    for bad in ({"throughput": 0.0}, {"throughput": 1.0, "overhead": -1},
                {"throughput": 1.0, "dropouts": [[2.0, 1.0]]}):
        with pytest.raises(ValueError) as e1:
            sim.node_from_trace(0, bad)
        with pytest.raises(ValueError) as e2:
            jsim.node_from_trace(0, bad)
        assert str(e1.value) == str(e2.value)


def _links(topo):
    return {k: (v.bandwidth, v.latency) for k, v in topo._links.items()}


TOPOLOGIES = {
    "full": lambda m: m.Topology.full(6),
    "star": lambda m: m.Topology.star(5, 2),
    "ring": lambda m: m.Topology.ring(7),
    "ring-2": lambda m: m.Topology.ring(2),
    "k-regular": lambda m: m.Topology.k_regular(8, 3),
    "small-world": lambda m: m.Topology.small_world(12, 4, 0.4, seed=3),
    "trace": lambda m: m.Topology.from_trace({
        "n": 5, "kind": "k_regular", "k": 2,
        "default": {"bandwidth": 2e6, "latency": 0.01},
        "links": {"0-1": {"bandwidth": 1e5, "latency": 0.3}},
        "schedule": [{"t": 1.0, "link": "0-1", "down": True},
                     {"t": 2.0, "link": "0-1", "bandwidth": 5e5},
                     {"t": 0.5, "link": "2-4", "bandwidth": 1e3,
                      "latency": 0.2}]}),
}


@pytest.mark.parametrize("kind", sorted(TOPOLOGIES))
def test_topologies_are_the_references(kind):
    ours, ref = TOPOLOGIES[kind](sim), TOPOLOGIES[kind](jsim)
    assert ours.name == ref.name and ours.n == ref.n
    for t in (0.0, 0.6, 1.5, 2.0, 9.0):
        assert ours.advance_to(t) == ref.advance_to(t)
        assert _links(ours) == _links(ref)
        for i in range(ours.n):
            assert ours.neighbors(i) == ref.neighbors(i)
            assert ours.degree(i) == ref.degree(i)
            for j in ours.neighbors(i):
                assert ours.transfer_time(i, j, 1e6) == \
                    ref.transfer_time(i, j, 1e6)
    if ours.schedule is not None:
        assert ours.schedule.to_trace() == ref.schedule.to_trace()


def test_topology_errors_are_the_references():
    for build in (lambda m: m.Topology.k_regular(5, 3),
                  lambda m: m.Topology.small_world(4, 5, 0.1),
                  lambda m: m.Topology.from_trace({"n": 3, "kind": "mesh"}),
                  lambda m: m.Topology.ring(4).link(0, 2),
                  lambda m: m.Link(0.0)):
        with pytest.raises(ValueError) as e1:
            build(sim)
        with pytest.raises(ValueError) as e2:
            build(jsim)
        assert str(e1.value) == str(e2.value)


# -- the backend within the port ---------------------------------------------


_IDEAL_LINK = sim.Link(bandwidth=1e15, latency=0.0)


def _ideal_topology(kind):
    if kind == "star":
        return sim.Topology.star(H, 0, _IDEAL_LINK)
    if kind == "ring":
        return sim.Topology.ring(H, _IDEAL_LINK)
    return sim.Topology.full(H, _IDEAL_LINK)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ideal_and_sim_agree_bit_for_bit(setup, case):
    """The "host" group's promise, for every arm: uniform nodes and ideal
    links give ``sim`` the ``ideal`` trajectory exactly (payload sums are
    the same ascending fold on the same device; with SecAgg both sessions'
    masks cancel in the same field sum)."""
    assert backends.bit_exact_groups() == {"host": ("ideal", "sim"),
                                           "spmd": ("shard",)}
    name, kw = case
    c = cfg(0.8, **kw)
    kind = arms.get(name).topology_kind
    ideal = arms.run(name, setup["tmodel"], setup["tsilos"], c,
                     topo=_ideal_topology(kind))
    simmed = arms.run(name, setup["tmodel"], setup["tsilos"], c,
                      backend="sim", topo=_ideal_topology(kind),
                      nodes=sim.nodes_from_trace(
                          [{"throughput": 1000.0, "overhead": 0.01}] * H))
    assert ideal.rounds_completed == simmed.rounds_completed
    for a, b in zip(jax.tree_util.tree_leaves(ideal.params),
                    jax.tree_util.tree_leaves(simmed.params)):
        assert torch.equal(a, b)
    for pa, pb in zip(ideal.per_node_params or [],
                      simmed.per_node_params or []):
        for a, b in zip(jax.tree_util.tree_leaves(pa),
                        jax.tree_util.tree_leaves(pb)):
            assert torch.equal(a, b)
    if simmed.logs:
        assert [l.loss for l in ideal.logs] == [l.loss for l in simmed.logs] \
            or all(np.isnan(l.loss) for l in ideal.logs + simmed.logs)
    assert ideal.epsilon == simmed.epsilon
    assert simmed.timing is not None and simmed.timing.wall_clock > 0


def test_sim_round_is_one_program_call(setup):
    for name in ("decaph", "primia", "scaffold"):
        fused.reset_jit_dispatches()
        rep = arms.run(name, setup["tmodel"], setup["tsilos"], cfg(0.8),
                       backend="sim", nodes=trace())
        assert fused.jit_dispatches() == rep.rounds_completed == 3


@pytest.mark.parametrize("name,kw", [("decaph", {}),
                                     ("decaph", {"use_secagg": True}),
                                     ("primia", {}), ("fl", {})])
def test_sim_round_syncs_the_host_once(setup, name, kw):
    """The event loop ships uploads one by one, but a round's losses (and,
    with SecAgg, its payloads) leave the device in one copy: one ``.cpu()``
    per round, no ``.item()`` and no ``float(tensor)`` per hospital."""
    counts = {"cpu": 0, "item": 0, "float": 0}
    real_cpu, real_item = torch.Tensor.cpu, torch.Tensor.item
    real_float = torch.Tensor.__float__

    def counted(key, fn):
        def wrapper(self, *a, **k):
            counts[key] += 1
            return fn(self, *a, **k)
        return wrapper

    with mock.patch.object(torch.Tensor, "cpu", counted("cpu", real_cpu)), \
            mock.patch.object(torch.Tensor, "item",
                              counted("item", real_item)), \
            mock.patch.object(torch.Tensor, "__float__",
                              counted("float", real_float)):
        rep = arms.run(name, setup["tmodel"], setup["tsilos"],
                       cfg(0.8, **kw), backend="sim", nodes=trace())
    assert rep.rounds_completed == 3
    # fl logs no loss, so its payloads and reduction never leave the card
    assert counts == {"cpu": 0 if name == "fl" else 3, "item": 0,
                      "float": 0}


def test_sim_honours_the_epsilon_budget(setup):
    c = cfg(0.8, rounds=40, epsilon_budget=3.0)
    ideal = arms.run("decaph", setup["tmodel"], setup["tsilos"], c)
    simmed = arms.run("decaph", setup["tmodel"], setup["tsilos"], c,
                      backend="sim", nodes=trace())
    assert ideal.rounds_completed == simmed.rounds_completed < 40
    assert simmed.epsilon == ideal.epsilon <= 3.0


@pytest.mark.parametrize("threshold", [None, 3, 4])
def test_secagg_threshold_sets_the_session_and_the_quorum(setup, threshold):
    seen = []
    real = runners.DropoutRobustSession

    def spy(*a, **kw):
        session = real(*a, **kw)
        seen.append(session.threshold)
        return session

    c = cfg(use_secagg=True, secagg_threshold=threshold, rounds=2)
    arm = arms.get("decaph")(setup["tmodel"], setup["tsilos"], c)
    assert arm.quorum() == (max(2, threshold or 2), None)
    with mock.patch.object(runners, "DropoutRobustSession", spy):
        rep = arms.run("decaph", setup["tmodel"], setup["tsilos"], c,
                       backend="sim", nodes=trace())
    assert rep.rounds_completed == 2
    assert seen == [threshold or H // 2 + 1] * 2
    # below the quorum the run waits; with no rejoin it never starts
    if threshold == 4:
        tr = sim.heterogeneous_trace(H)
        tr[1] = dict(tr[1], dropouts=[[0.0, None]])
        rep = arms.run("decaph", setup["tmodel"], setup["tsilos"], c,
                       backend="sim", nodes=sim.nodes_from_trace(tr))
        assert rep.rounds_completed == 0 and rep.timing.dropout_events == 1


def test_sim_refuses_what_it_cannot_run(setup):
    with pytest.raises(ValueError, match="needs nodes="):
        arms.run("fl", setup["tmodel"], setup["tsilos"], cfg(),
                 backend="sim")
    with pytest.raises(ValueError, match="one HospitalNode per participant"):
        arms.run("fl", setup["tmodel"], setup["tsilos"], cfg(),
                 backend="sim", nodes=sim.nodes_from_trace(
                     sim.heterogeneous_trace(H - 1)))
    # the fused-only population backend refuses a node arm, as the
    # reference's does
    with pytest.raises(ValueError, match="only executes fused-capable round "
                                         "arms; arm 'gossip'"):
        arms.run("gossip", setup["tmodel"], setup["tsilos"], cfg(),
                 backend="population")
    with pytest.raises(KeyError, match="registered backends: ideal, "
                                       "population, shard, sim"):
        backends.get_backend("tpu")


# the reference's refusals of the shard backend (tests/test_backends.py),
# each with its message: the arm/config rules before any compute, and the
# missing process group (this process joins none) at construction
SHARD_REFUSALS = [
    ("secagg", "decaph", {"use_secagg": True}, ValueError, "SecAgg"),
    ("node-arm", "gossip", {}, ValueError, "fused-capable round arms"),
    ("loop", "decaph", {"fused_rounds": False}, ValueError,
     "fused_rounds=False"),
    ("no-group", "decaph", {}, RuntimeError,
     "backend 'shard' unavailable: needs a torch.distributed process group"),
]


@pytest.mark.parametrize("case", SHARD_REFUSALS, ids=lambda c: c[0])
def test_shard_refuses_what_it_cannot_run(setup, case):
    _, arm, kw, error, message = case
    assert backends.availability("shard") is not None
    with pytest.raises(error, match=message):
        arms.run(arm, setup["tmodel"], setup["tsilos"], cfg(**kw),
                 backend="shard")

"""``repro_torch.core.federation`` (the deprecated ``run_*`` shims and the
PATE baseline) against ``repro.core.federation``, on the CPU.

The shims run the GEMINI-like MLP of ``_torch_gemini`` (the reference's
weights carried node by node): at sigma = 0 parameters and losses agree
within 1e-5; at sigma = 0.8 ε and the privacy ledger are bit-identical.
``run_pate`` runs the reference's 3-silo, 5-feature fixture
(``tests/test_federation.py``) with an MLP 5-16-1 whose teachers and
student start from the reference's weights (``tabular_params_from_jax``):
the GNMax labels are the reference's, ε bit for bit, the student within
1e-5.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core.federation as jfed
import repro.obs as jobs
from repro.models import tabular as jtab
import repro_torch.arms as arms
import repro_torch.core.federation as fed
import repro_torch.obs as obs
from repro_torch.convert import tabular_params_from_jax, tabular_params_to_numpy
from repro_torch.core.accountant import DEFAULT_ORDERS, rdp_to_eps_delta
from repro_torch.models import tabular

from _torch_gemini import cfg, make_setup, max_diff

torch.set_num_threads(1)

ATOL = 1e-5
SHIMS = [("run_decaph", "decaph", {}), ("run_fl", "fl", {}),
         ("run_fl", "fl", {"fl_local_steps": 3}),
         ("run_primia", "primia", {}), ("run_local", "local", {})]


def _id(case):
    return case[0] + "".join(f"-{k}={v}" for k, v in case[2].items())


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _run(module, shim, model, silos, config):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return getattr(module, shim)(model, silos, config)


def test_module_surface_is_the_references():
    assert fed.__all__ == jfed.__all__
    assert list(fed.RUNNERS) == list(jfed.RUNNERS)
    assert fed.FederationConfig is arms.ArmConfig
    assert fed.RunResult is arms.RunReport
    assert fed._sgd_update is arms.sgd_update
    assert fed._poisson_batch is arms.poisson_batch


@pytest.mark.parametrize("case", SHIMS, ids=_id)
def test_shim_matches_reference_at_sigma0(setup, case):
    shim, arm, kw = case
    ours = _run(fed, shim, setup["tmodel"], setup["tsilos"], cfg(**kw))
    ref = _run(jfed, shim, setup["jmodel"], setup["jsilos"],
               cfg(port=False, **kw))
    assert ours.arm == ref.arm == arm and ours.backend == "ideal"
    assert ours.rounds_completed == ref.rounds_completed == 3
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=0, atol=ATOL)
    assert max_diff(ours.params, ref.params) <= ATOL
    assert (ours.per_client_params is None) == (ref.per_client_params is None)
    for a, b in zip(ours.per_client_params or [], ref.per_client_params or []):
        assert max_diff(a, b) <= ATOL


@pytest.mark.parametrize("shim, arm", [(s, a) for s, a, kw in SHIMS if not kw])
def test_shims_warn_with_the_ports_names(setup, shim, arm):
    with pytest.warns(DeprecationWarning) as caught:
        getattr(fed, shim)(setup["tmodel"], setup["tsilos"], cfg(rounds=1))
    w, = [w for w in caught if w.category is DeprecationWarning]
    assert str(w.message) == (
        f"repro_torch.core.federation.{shim} is deprecated; use "
        f"repro_torch.arms.run({arm!r}, ...) (idealized backend) or "
        "repro_torch.arms.SimRunner for simulated time")
    assert w.filename == __file__           # stacklevel=3: the caller's line


@pytest.mark.parametrize("shim", ["run_decaph", "run_primia"])
def test_epsilon_and_ledger_are_bit_identical(setup, shim):
    with obs.recording() as rec:
        ours = _run(fed, shim, setup["tmodel"], setup["tsilos"], cfg(0.8))
        rows = rec.ledger.entries()
    with jobs.recording() as jrec:
        ref = _run(jfed, shim, setup["jmodel"], setup["jsilos"],
                   cfg(0.8, port=False))
        jrows = jrec.ledger.entries()
    assert len(rows) > 0 and rows == jrows
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]


def test_decaph_shim_is_arms_run_bit_for_bit(setup):
    """The shim pins ``fused_rounds=False``; the port's per-participant path
    is its cohort step on a cohort of one, so the shim, the per-participant
    ``arms.run`` and the fused default agree bit for bit, noise included."""
    shim = _run(fed, "run_decaph", setup["tmodel"], setup["tsilos"], cfg(0.8))
    loop = arms.run("decaph", setup["tmodel"], setup["tsilos"],
                    cfg(0.8, fused_rounds=False))
    whole = arms.run("decaph", setup["tmodel"], setup["tsilos"], cfg(0.8))
    for other in (loop, whole):
        assert other.epsilon == shim.epsilon
        assert [dataclasses.astuple(l) for l in other.logs] == \
            [dataclasses.astuple(l) for l in shim.logs]
        for k in shim.params:
            for name in shim.params[k]:
                assert torch.equal(other.params[k][name], shim.params[k][name])


# -- PATE ---------------------------------------------------------------------

PATE_SIZES = [5, 16, 1]


def _silos(package_participant, seed=0, sizes=(180, 120, 90)):
    """The 3-silo, 5-feature fixture of ``tests/test_federation.py``."""
    rng = np.random.default_rng(seed)
    w_true = np.array([1.5, -2.0, 1.0, 0.0, 0.5])
    out = []
    for i, n in enumerate(sizes):
        x = rng.normal(0.1 * i, 1.0, (n, 5)).astype(np.float32)
        y = (x @ w_true + rng.normal(0, 0.2, n) > 0).astype(np.float32)
        out.append(package_participant(x, y))
    return out


def _public_x(n=60):
    return np.random.default_rng(3).normal(0, 1, (n, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def pate():
    jmodel = jtab.make_mlp_classifier(PATE_SIZES, "binary")
    # local seeds node i with seed + i; the student is node 0
    table = {s: jax.tree_util.tree_map(np.asarray,
                                       jmodel.init_fn(jax.random.key(s)))
             for s in range(3)}
    tmodel = dataclasses.replace(
        tabular.make_mlp_classifier(PATE_SIZES, "binary", device="cpu"),
        init_fn=lambda seed: tabular_params_from_jax(table[seed],
                                                     device="cpu"))
    return dict(jmodel=jmodel, tmodel=tmodel,
                jsilos=_silos(jfed.Participant), tsilos=_silos(fed.Participant))


def _pate_cfg(port=True):
    return (fed if port else jfed).FederationConfig(
        rounds=15, batch_size=32, lr=0.5, seed=0)


def _capture(monkeypatch, module):
    """Record every ``_run_ideal`` call of ``module``'s ``run_pate``:
    (arm, participants, result)."""
    calls = []
    inner = module._run_ideal

    def spy(arm, model, participants, config):
        res = inner(arm, model, participants, config)
        calls.append((arm, participants, res))
        return res

    monkeypatch.setattr(module, "_run_ideal", spy)
    return calls


@pytest.mark.parametrize("gnmax_sigma", [2.0, 4.0])
def test_pate_matches_reference(pate, monkeypatch, gnmax_sigma):
    public_x = _public_x()
    calls = _capture(monkeypatch, fed)
    jcalls = _capture(monkeypatch, jfed)
    ours = fed.run_pate(pate["tmodel"], pate["tsilos"], _pate_cfg(),
                        public_x=public_x, gnmax_sigma=gnmax_sigma)
    ref = jfed.run_pate(pate["jmodel"], pate["jsilos"], _pate_cfg(False),
                        public_x=public_x, gnmax_sigma=gnmax_sigma)
    assert (ours.arm, ours.backend) == (ref.arm, ref.backend) == \
        ("pate", "ideal")
    assert ours.rounds_completed == ref.rounds_completed == 15
    assert ours.logs == ref.logs == []
    assert ours.epsilon == ref.epsilon
    assert [c[0] for c in calls] == [c[0] for c in jcalls] == \
        ["local", "local"]
    # the teachers: within 1e-5, and no vote near the 0.5 threshold (so the
    # two packages' votes cannot split on an ulp)
    for a, b in zip(calls[0][2].per_node_params, jcalls[0][2].per_node_params):
        assert max_diff(a, b) <= ATOL
        score = np.asarray(pate["jmodel"].predict_fn(b, public_x))
        assert np.min(np.abs(score - 0.5)) > 1e-4
    (student,), (jstudent,) = calls[1][1], jcalls[1][1]
    np.testing.assert_array_equal(student.x, jstudent.x)
    np.testing.assert_array_equal(student.y, jstudent.y)   # the GNMax labels
    assert student.y.dtype == jstudent.y.dtype == np.float32
    assert max_diff(ours.params, ref.params) <= ATOL


def test_pate_epsilon_is_the_composed_gaussian_and_grows_with_the_pool(pate):
    public_x = _public_x()
    res = fed.run_pate(pate["tmodel"], pate["tsilos"], _pate_cfg(),
                       public_x=public_x, gnmax_sigma=4.0)
    orders = np.asarray(DEFAULT_ORDERS)
    eps, _ = rdp_to_eps_delta(len(public_x) * orders / (2.0 * 4.0**2),
                              orders, 1e-5)
    assert res.epsilon == eps > 0
    more = fed.run_pate(pate["tmodel"], pate["tsilos"], _pate_cfg(),
                        public_x=np.concatenate([public_x, public_x]),
                        gnmax_sigma=4.0)
    assert more.epsilon > res.epsilon       # per-query composition
    tabular_params_to_numpy(more.params)    # a plain tree of the model


def test_pate_multiclass_labels_match_reference():
    """Three classes: argmax votes, int32 labels."""
    sizes = [5, 8, 3]
    jmodel = jtab.make_mlp_classifier(sizes, "multiclass")
    table = {s: jax.tree_util.tree_map(np.asarray,
                                       jmodel.init_fn(jax.random.key(s)))
             for s in range(1, 4)}                   # seed 1, 3 silos
    tmodel = dataclasses.replace(
        tabular.make_mlp_classifier(sizes, "multiclass", device="cpu"),
        init_fn=lambda seed: tabular_params_from_jax(table[seed],
                                                     device="cpu"))

    def silos(part):
        out = []
        for p in _silos(part):
            y = np.digitize(p.x[:, 0] - p.x[:, 1], [-1.0, 1.0])
            out.append(part(p.x, y.astype(np.int32)))
        return out

    config = dict(rounds=5, batch_size=32, lr=0.3, seed=1)
    ours = fed.run_pate(tmodel, silos(fed.Participant),
                        fed.FederationConfig(**config), public_x=_public_x(),
                        n_classes=3, gnmax_sigma=1.0)
    ref = jfed.run_pate(jmodel, silos(jfed.Participant),
                        jfed.FederationConfig(**config), public_x=_public_x(),
                        n_classes=3, gnmax_sigma=1.0)
    assert ours.epsilon == ref.epsilon
    assert max_diff(ours.params, ref.params) <= ATOL

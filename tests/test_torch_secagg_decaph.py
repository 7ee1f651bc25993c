"""DeCaPH with SecAgg on — the paper's protocol — against the JAX reference.

Three of the paper's models at small sizes on their synthetic hospitals,
normalised as the reference's preparation phase does: the GEMINI MLP
(436-300-100-50-10-1 with 16 features) on 4 hospitals, the scenarios'
"small" pancreas MLP and "small" DenseNet.  Both packages start from the
reference's weights (``tabular_params_from_jax``) and run ``ArmConfig``
with ``use_secagg=True`` on the ``ideal`` backend: noise shares, batch
sizes through ``secure_sum_ints`` and payloads through fixed-point
``secure_sum``.  The port's pads differ from the reference's, but the
field sums do not, so at sigma = 0 three rounds match within 1e-5 with
identical aggregate batches, and at sigma = 0.8 ε and the privacy ledger
are bit-identical.
"""

import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro.obs as jobs
from repro.core.dp import DPConfig as JDPConfig
from repro.data import synthetic as jsynthetic
from repro.models import tabular as jtab
import repro_torch.arms as arms
import repro_torch.obs as obs
from repro_torch.arms import fused, runners
from repro_torch.convert import tabular_params_from_jax, tabular_params_to_numpy
from repro_torch.core import accountant, dp
from repro_torch.data import synthetic
from repro_torch.models import tabular

torch.set_num_threads(1)

ROUND_ATOL = 1e-5

CASES = {
    # name: (model(module, **device), data(module), batch, lr, clip)
    "gemini_mlp": (
        lambda m, **d: m.make_mlp_classifier([16, 300, 100, 50, 10, 1],
                                             "binary", **d),
        lambda s: s.make_gemini_like(seed=0, n_total=400, n_silos=4,
                                     n_features=16),
        32, 0.5, 1.0),
    "pancreas_small": (
        lambda m, **d: m.make_mlp_classifier([128, 32, 4], "multiclass", **d),
        lambda s: s.make_pancreas_like(seed=0, n_total=600, n_genes=128),
        48, 0.3, 0.5),
    "densenet_small": (
        lambda m, **d: m.make_densenet(m.DenseNetConfig(
            growth=4, blocks=(1, 1), init_channels=8, image_size=16), **d),
        lambda s: s.make_xray_like(seed=0, n_total=300, image_size=16),
        24, 0.1, 0.5),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    make, data, batch, lr, clip = CASES[request.param]
    jmodel = make(jtab)
    p0 = jax.tree_util.tree_map(np.asarray, jmodel.init_fn(jax.random.key(0)))
    tmodel = dataclasses.replace(
        make(tabular, device="cpu"),
        init_fn=lambda seed: tabular_params_from_jax(p0, device="cpu"))
    return dict(name=request.param, jmodel=jmodel, tmodel=tmodel,
                jsilos=jarms.normalize_participants(data(jsynthetic)),
                tsilos=arms.normalize_participants(data(synthetic)),
                batch=batch, lr=lr, clip=clip)


def _cfg(c, sigma, *, port=True, **kw):
    mod, dpc = (arms, dp.DPConfig) if port else (jarms, JDPConfig)
    base = dict(rounds=3, batch_size=c["batch"], lr=c["lr"], use_secagg=True,
                dp=dpc(clip_norm=c["clip"], noise_multiplier=sigma,
                       microbatch_size=8))
    base.update(kw)
    return mod.ArmConfig(**base)


def _run_port(c, sigma=0.0, **kw):
    return arms.run("decaph", c["tmodel"], c["tsilos"], _cfg(c, sigma, **kw))


def _run_jax(c, sigma=0.0, **kw):
    return jarms.run("decaph", c["jmodel"], c["jsilos"],
                     _cfg(c, sigma, port=False, **kw))


def test_sigma0_secagg_rounds_match_reference(case):
    ours, ref = _run_port(case), _run_jax(case)
    assert ours.rounds_completed == ref.rounds_completed == 3
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=1e-5)
    a = jax.tree_util.tree_leaves(tabular_params_to_numpy(ours.params))
    b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                         ref.params))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=ROUND_ATOL, rtol=0)


def test_epsilon_and_ledger_are_bit_identical_with_secagg(case):
    with obs.recording() as rec:
        ours = _run_port(case, 0.8)
        rows = rec.ledger.entries()
    with jobs.recording() as jrec:
        ref = _run_jax(case, 0.8)
        jrows = jrec.ledger.entries()
    assert rows and rows == jrows
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    n = sum(len(p) for p in case["tsilos"])
    acct = accountant.RDPAccountant(sampling_rate=case["batch"] / n,
                                    noise_multiplier=0.8, delta=1e-5)
    acct.step(3)
    assert ours.epsilon == acct.epsilon()
    # the aggregate span says the sums went through SecAgg
    spans = [e for e in rec.events() if e.get("name") == "aggregate"]
    assert len(spans) == 3 and all(e["args"]["secure"] for e in spans)


def test_one_program_call_per_round_with_secagg(case):
    def calls(rounds):
        fused.reset_jit_dispatches()
        _run_port(case, 0.8, rounds=rounds)
        return fused.jit_dispatches()

    assert calls(3) == 3
    assert calls(1) == 1


def test_default_config_runs_secagg_on_the_cpu_when_asked(case):
    """``ArmConfig()`` defaults to SecAgg: one secure sum of the payloads
    and one of the batch sizes per round, every participant's payload a
    host numpy view, and no reduced sum on the device."""
    cfg = arms.ArmConfig(rounds=2, batch_size=case["batch"])
    assert cfg.use_secagg and cfg.secagg_frac_bits == 16
    seen = {"sum": [], "ints": [], "reduced": []}
    real_sum, real_ints = runners.secure_sum, runners.secure_sum_ints
    real_round = arms.get("decaph").fused_round

    def spy_sum(trees, scfg, **kw):
        seen["sum"].append((len(trees), scfg, type(trees[0])))
        assert all(isinstance(v, np.ndarray) for v in
                   jax.tree_util.tree_leaves(trees))
        return real_sum(trees, scfg, **kw)

    def spy_ints(sizes, **kw):
        seen["ints"].append(kw)
        return real_ints(sizes, **kw)

    def spy_round(self, *a, **kw):
        contribs, reduced = real_round(self, *a, **kw)
        seen["reduced"].append(reduced)
        return contribs, reduced

    with mock.patch.object(runners, "secure_sum", spy_sum), \
            mock.patch.object(runners, "secure_sum_ints", spy_ints), \
            mock.patch.object(arms.get("decaph"), "fused_round", spy_round):
        report = arms.run("decaph", case["tmodel"], case["tsilos"], cfg)
    h = len(case["tsilos"])
    assert report.rounds_completed == 2
    assert [(n, s.seed, s.frac_bits) for n, s, _ in seen["sum"]] == \
        [(h, 0, 16), (h, 1, 16)]
    assert [kw["seed"] for kw in seen["ints"]] == [0, 1]
    assert seen["reduced"] == [None, None]
    assert all(t.device.type == "cpu"
               for t in jax.tree_util.tree_leaves(report.params))

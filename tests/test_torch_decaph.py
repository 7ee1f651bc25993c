"""repro_torch DeCaPH rounds against the JAX reference, on the CPU.

The ``tests/test_ghost_fused.py`` setup: ``smollm-360m`` smoke with
untied embeddings, 3 ``token_silos`` hospitals, batch 12, 3 rounds on the
``ideal`` backend without SecAgg, both packages starting from the same
parameters (the reference's, carried across with ``params_from_jax``).

JAX's threefry noise cannot be reproduced by a torch generator, so the
noised path is held to the reference in three parts: at sigma = 0 the
trajectories match (atol 1e-5, the reference's own fused-vs-shard
tolerance); at sigma > 0 the noise share has the right variance; and ε and
the privacy ledger — which never depend on the draws — are bit-identical
at sigma = 0.8 (at sigma = 0, ε is inf).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro.obs as jobs
import repro_torch.arms as arms
import repro_torch.obs as obs
from repro.arms import fused as jfused
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import accountant as jacct
from repro.core.dp import DPConfig as JDPConfig
from repro.core.leader import leader_schedule as jax_leader_schedule
from repro.obs.ledger import validate_entries as jax_validate_entries
from repro.serve.federation import token_silos as jax_token_silos
from repro.serve.federation import transformer_model as jax_transformer_model
from repro_torch.arms import fused
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import accountant, dp
from repro_torch.core.leader import leader_schedule
from repro_torch.serve.federation import token_silos, transformer_model

torch.set_num_threads(1)

ROUND_ATOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_smoke_config("smollm-360m").replace(tie_embeddings=False)
    tcfg = get_smoke_config("smollm-360m").replace(tie_embeddings=False)
    jmodel = jax_transformer_model(jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, jmodel.init_fn(jax.random.key(0)))
    tmodel = dataclasses.replace(transformer_model(tcfg, device="cpu"),
                                 init_fn=lambda seed: params_from_jax(p0,
                                                                      tcfg))
    return dict(
        jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, tmodel=tmodel,
        jsilos=jax_token_silos(jcfg, hospitals=3, n_per=16, seq_len=12,
                               seed=0),
        tsilos=token_silos(tcfg, hospitals=3, n_per=16, seq_len=12, seed=0),
    )


def _cfg(sigma=0.0, *, port=True, **kw):
    mod, dpc = (arms, dp.DPConfig) if port else (jarms, JDPConfig)
    base = dict(rounds=3, batch_size=12, lr=0.05, use_secagg=False,
                dp=dpc(clip_norm=1.0, noise_multiplier=sigma,
                       microbatch_size=8))
    base.update(kw)
    return mod.ArmConfig(**base)


def _run_port(lm, sigma=0.0, **kw):
    return arms.run("decaph", lm["tmodel"], lm["tsilos"], _cfg(sigma, **kw))


def _run_jax(lm, sigma=0.0, **kw):
    return jarms.run("decaph", lm["jmodel"], lm["jsilos"],
                     _cfg(sigma, port=False, **kw))


def _max_param_diff(port_params, cfg, jax_params):
    ours = jax.tree_util.tree_leaves(params_to_numpy(port_params, cfg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jax_params))
    return max(float(np.max(np.abs(a - b))) for a, b in zip(ours, ref))


def test_token_silos_are_the_references(lm):
    for ours, ref in zip(lm["tsilos"], lm["jsilos"]):
        np.testing.assert_array_equal(ours.x, ref.x)
        np.testing.assert_array_equal(ours.y, ref.y)


def test_poisson_cohort_draws_are_the_references(lm):
    ours = fused.stack_poisson(np.random.default_rng(5), lm["tsilos"],
                               [0, 1, 2], 0.3, 8)
    ref = jfused.stack_poisson(np.random.default_rng(5), lm["jsilos"],
                               [0, 1, 2], 0.3, 8)
    for name in ("x", "y", "masks"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    assert ours.sizes == ref.sizes


def test_sigma0_rounds_match_reference(lm):
    ours, ref = _run_port(lm), _run_jax(lm)
    assert ours.rounds_completed == ref.rounds_completed == 3
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=1e-5)
    assert _max_param_diff(ours.params, lm["tcfg"], ref.params) <= ROUND_ATOL


def test_epsilon_and_ledger_are_bit_identical(lm):
    """ε never depends on the draws: at sigma = 0.8 every ledger entry —
    hash chain included — is the reference's, byte for byte."""
    with obs.recording() as rec:
        ours = _run_port(lm, 0.8)
        rows = rec.ledger.entries()
    with jobs.recording() as jrec:
        ref = _run_jax(lm, 0.8)
        jrows = jrec.ledger.entries()
    assert rows and rows == jrows
    jax_validate_entries(rows)
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]
    acct = accountant.RDPAccountant(sampling_rate=12 / 48,
                                    noise_multiplier=0.8, delta=1e-5)
    acct.step(3)
    assert ours.epsilon == acct.epsilon()


def test_accountant_is_the_references():
    for p, sigma, steps in [(0.01, 1.1, 100), (0.25, 0.8, 3), (1.0, 2.0, 7),
                            (0.05, 0.5, 1000)]:
        assert accountant.compute_epsilon(p, sigma, steps, 1e-5) == \
            jacct.compute_epsilon(p, sigma, steps, 1e-5)
    assert accountant.steps_for_epsilon(0.01, 1.0, 2.0, 1e-5) == \
        jacct.steps_for_epsilon(0.01, 1.0, 2.0, 1e-5)


def test_noise_share_has_the_calibrated_variance():
    """Each of n shares is N(0, (C sigma)^2 / n).  With 400,000 draws the
    sample variance's standard error is sqrt(2/N) = 0.22% of the true
    variance; the bound is 2% (9 standard errors), the mean within 0.01."""
    clip, sigma, n = 1.5, 0.8, 4
    gen = torch.Generator().manual_seed(dp.noise_seed(0, 17, 2))
    template = {"w": torch.zeros(200, 1000), "b": {"c": torch.zeros(200_000)}}
    share = dp.noise_share(gen, template, clip_norm=clip,
                           noise_multiplier=sigma, n_shares=n)
    draws = torch.cat([share["w"].reshape(-1), share["b"]["c"]]).double()
    want = (clip * sigma) ** 2 / n
    assert abs(float(draws.var()) / want - 1.0) < 0.02
    assert abs(float(draws.mean())) < 0.01
    # seeds are a pure function of (seed, salt + round, participant)
    assert dp.noise_seed(0, 17, 2) == dp.noise_seed(0, 17, 2)
    assert len({dp.noise_seed(0, 17 + t, i) for t in range(3)
                for i in range(3)}) == 9


def test_ghost_matches_faithful_in_the_port(lm):
    ghost = _run_port(lm, 0.8, clipping="ghost")
    faithful = _run_port(lm, 0.8, clipping="per-example")
    assert ghost.rounds_completed == faithful.rounds_completed
    assert ghost.epsilon == faithful.epsilon
    ours = jax.tree_util.tree_leaves(params_to_numpy(ghost.params, lm["tcfg"]))
    ref = jax.tree_util.tree_leaves(params_to_numpy(faithful.params,
                                                    lm["tcfg"]))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=ROUND_ATOL, rtol=0)


def test_one_program_call_per_fused_round(lm):
    def calls(rounds):
        fused.reset_jit_dispatches()
        _run_port(lm, 0.8, rounds=rounds)
        return fused.jit_dispatches()

    d2, d5 = calls(2), calls(5)
    assert d5 - d2 == 3


@pytest.mark.parametrize("backend,kw,match", [
    ("sim", {}, "only 'ideal'"),
    ("ideal", dict(participation_rate=0.5), "subsampling"),
])
def test_ideal_backend_refuses_what_it_cannot_run(lm, backend, kw, match):
    """Refused at validation, before any compute — never run otherwise."""
    with pytest.raises(ValueError, match=match):
        arms.run("decaph", lm["tmodel"], lm["tsilos"], _cfg(0.8, **kw),
                 backend=backend)


def test_secagg_is_refused_at_validation(lm):
    with pytest.raises(ValueError, match="Queue 1 item 5"):
        arms.run("decaph", lm["tmodel"], lm["tsilos"],
                 _cfg(0.8, use_secagg=True))


@pytest.mark.parametrize("strategy", ["round_robin", "balanced"])
def test_leader_schedules_are_the_references(strategy):
    np.testing.assert_array_equal(
        leader_schedule(5, 23, seed=3, strategy=strategy),
        jax_leader_schedule(5, 23, seed=3, strategy=strategy))


def test_uniform_leaders_are_seeded_and_in_range():
    a = leader_schedule(4, 50, seed=1)
    np.testing.assert_array_equal(a, leader_schedule(4, 50, seed=1))
    assert a.min() >= 0 and a.max() < 4

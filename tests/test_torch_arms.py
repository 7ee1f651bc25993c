"""Every federation arm of the port against the JAX reference, on the CPU.

The GEMINI-like MLP 16-300-100-50-10-1 on 4 normalised hospitals, 3
rounds (node arms: 3 local steps each), on the ``ideal`` backend, both
packages from the reference's weights (``_torch_gemini``).

JAX's threefry noise cannot be reproduced by a torch generator, so, as for
decaph: at sigma = 0 parameters and losses agree within 1e-5; at sigma =
0.8 ε and the privacy ledger are bit-identical and the noise has the
calibrated variance.  The per-participant path (``fused_rounds=False``)
is the port's cohort step on a cohort of one, so it reproduces the fused
round bit for bit, noise included.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro.obs as jobs
import repro_torch.arms as arms
import repro_torch.obs as obs
from repro_torch.arms import fused
from repro_torch.arms.gossip import node_seed
from repro_torch.core import accountant

from _torch_gemini import H, case_id as _id, cfg, make_setup, max_diff

torch.set_num_threads(1)

ROUND_ATOL = 1e-5

# (arm, extra config): every registered arm, fl as FedSGD and FedAvg
CASES = [("decaph", {}), ("fedprox", {}), ("fl", {}),
         ("fl", {"fl_local_steps": 3}), ("gossip", {}), ("gossip-dp", {}),
         ("local", {}), ("primia", {}), ("scaffold", {})]
ROUND_CASES = [c for c in CASES if arms.get(c[0]).mode == "round"]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def run_port(s, name, sigma=0.0, **kw):
    return arms.run(name, s["tmodel"], s["tsilos"], cfg(sigma, **kw))


def run_ref(s, name, sigma=0.0, **kw):
    key = (name, sigma, tuple(sorted(kw.items())))
    if key not in s["ref"]:
        s["ref"][key] = jarms.run(name, s["jmodel"], s["jsilos"],
                                  cfg(sigma, port=False, **kw))
    return s["ref"][key]


def _losses_close(ours, ref):
    a = np.asarray([l.loss for l in ours.logs], np.float64)
    b = np.asarray([l.loss for l in ref.logs], np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=0,
                               atol=ROUND_ATOL)


def test_arm_names_are_the_references():
    assert arms.names() == jarms.names()
    for name in arms.names():
        ours, ref = arms.get(name), jarms.get(name)
        for flag in ("mode", "private", "topology_kind"):
            assert getattr(ours, flag) == getattr(ref, flag), (name, flag)
        for flag in ("secure_uploads", "requires_dst_online", "void_logs",
                     "empty_break", "fused_capable", "distributed_noise"):
            assert getattr(ours, flag, None) == getattr(ref, flag, None), \
                (name, flag)


def test_arm_config_has_the_references_fields():
    ours = {f.name: f.default for f in dataclasses.fields(arms.ArmConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jarms.ArmConfig)}
    assert ours.keys() == ref.keys()
    assert {k: v for k, v in ours.items() if k != "dp"} == \
        {k: v for k, v in ref.items() if k != "dp"}


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sigma0_matches_reference(setup, case):
    name, kw = case
    ours, ref = run_port(setup, name, **kw), run_ref(setup, name, **kw)
    assert ours.rounds_completed == ref.rounds_completed == 3
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    assert [l.leader for l in ours.logs] == [l.leader for l in ref.logs] \
        or name == "decaph"          # decaph's uniform leader draw differs
    _losses_close(ours, ref)
    assert max_diff(ours.params, ref.params) <= ROUND_ATOL
    if ref.per_node_params is None:
        assert ours.per_node_params is None
    else:
        assert len(ours.per_node_params) == len(ref.per_node_params) == H
        for a, b in zip(ours.per_node_params, ref.per_node_params):
            assert max_diff(a, b) <= ROUND_ATOL
    assert ours.timing is None and ours.backend == "ideal"


@pytest.mark.parametrize("case", ROUND_CASES, ids=_id)
def test_per_participant_path_is_the_fused_round(setup, case):
    """``fused_rounds=False`` takes ``contribution`` (the cohort step on a
    cohort of one, one program call per participant) and reproduces the
    fused round bit for bit, noise included."""
    name, kw = case
    fused.reset_jit_dispatches()
    loop = run_port(setup, name, 0.8, rounds=2, fused_rounds=False, **kw)
    calls = fused.jit_dispatches()
    whole = run_port(setup, name, 0.8, rounds=2, **kw)
    assert calls == 2 * H
    assert loop.rounds_completed == whole.rounds_completed == 2
    for a, b in zip(jax.tree_util.tree_leaves(loop.params),
                    jax.tree_util.tree_leaves(whole.params)):
        assert torch.equal(a, b)
    assert [l.loss for l in loop.logs] == [l.loss for l in whole.logs] or \
        all(math.isnan(l.loss) for l in loop.logs + whole.logs)
    assert loop.epsilon == whole.epsilon


@pytest.mark.parametrize("name", [c[0] for c in ROUND_CASES
                                  if c[0] != "fl"] + ["fl"])
def test_one_program_call_per_fused_round(setup, name):
    def calls(rounds):
        fused.reset_jit_dispatches()
        run_port(setup, name, 0.8, rounds=rounds)
        return fused.jit_dispatches()

    assert calls(3) - calls(1) == 2


@pytest.mark.parametrize("name", ["primia", "gossip-dp"])
def test_epsilon_and_ledger_are_bit_identical(setup, name):
    """ε never depends on the draws: at sigma = 0.8 every ε and every ledger
    entry is the reference's; each client's ε is its own accountant's."""
    with obs.recording() as rec:
        ours = run_port(setup, name, 0.8)
        rows = rec.ledger.entries()
    with jobs.recording() as jrec:
        ref = run_ref(setup, name, 0.8)
        jrows = jrec.ledger.entries()
    assert rows == jrows
    assert (len(rows) > 0) == (name == "primia")   # round arms write rows
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]
    per_client = 32 // H            # batch_size // hospitals
    eps = []
    for p in setup["tsilos"]:
        acct = accountant.RDPAccountant(
            sampling_rate=min(1.0, per_client / len(p)),
            noise_multiplier=0.8, delta=1e-5)
        acct.step(3)
        eps.append(acct.epsilon())
    assert ours.epsilon == max(eps)


def _noise_ratio(setup, name):
    """(noised - clean) / expected std for one client's update, at sigma 0.8
    against 0, from the same draws."""
    sigma, clip = 0.8, 1.0
    arm_cls = arms.get(name)
    out = []
    for s in (sigma, 0.0):
        arm = arm_cls(setup["tmodel"], setup["tsilos"], cfg(s))
        params = setup["tmodel"].init_fn(0 if name == "primia"
                                         else node_seed(0, 1))
        if name == "primia":
            rng = np.random.default_rng(7)
            contribs, _ = arm.fused_round(params, [1], 0, rng, 1,
                                          payloads="device")
            k = contribs[1].size
            out.append(contribs[1].payload)
        else:
            new, _, k = arm.local_step(1, params, 0)
            # g = (new - params) / -lr
            out.append(jax.tree_util.tree_map(
                lambda a, b: (a - b) / -arm.cfg.lr, new, params))
    diff = torch.cat([(a - b).reshape(-1).double() for a, b in zip(
        jax.tree_util.tree_leaves(out[0]),
        jax.tree_util.tree_leaves(out[1]))])
    return diff / (clip * sigma / max(k, 1))


@pytest.mark.parametrize("name", ["primia", "gossip-dp"])
def test_local_noise_has_the_full_calibrated_variance(setup, name):
    """Local DP: each client's update carries N(0, (C sigma)^2) / k.  Over
    the MLP's 40,771 coordinates the sample variance's standard error is
    0.7%; the bound is 5% (7 standard errors)."""
    z = _noise_ratio(setup, name)
    assert z.numel() == 40_771
    assert abs(float(z.var()) - 1.0) < 0.05
    assert abs(float(z.mean())) < 0.03

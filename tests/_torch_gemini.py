"""Shared set-up of the port's arm and backend parity tests.

The GEMINI-like MLP 16-300-100-50-10-1 on 4 normalised hospitals
(``make_gemini_like(seed=0, n_total=400, n_silos=4, n_features=16)``) in
both packages, the port starting from the reference's weights
(``tabular_params_from_jax``) node by node: ``local`` seeds node i with
``seed + i`` in both packages, and ``gossip``'s ``node_seed(seed, i)``
stands for the reference's ``fold_in(key(seed), i)``.
"""

import dataclasses

import jax
import numpy as np

import repro.arms as jarms
import repro.sim as jsim
from repro.core.dp import DPConfig as JDPConfig
from repro.data import synthetic as jsynthetic
from repro.models import tabular as jtab
import repro_torch.arms as arms
import repro_torch.sim as sim
from repro_torch.arms.gossip import node_seed
from repro_torch.convert import tabular_params_from_jax, tabular_params_to_numpy
from repro_torch.core import dp
from repro_torch.data import synthetic
from repro_torch.models import tabular

H = 4
SIZES = [16, 300, 100, 50, 10, 1]
ROUND_ATOL = 1e-5
# hospital 3 drops out during round 1's upload and rejoins before round 3
DROPOUT = (3, 0.2, 0.35)


def make_setup() -> dict:
    jmodel = jtab.make_mlp_classifier(SIZES, "binary")
    keys = {0: jax.random.key(0)}
    for i in range(H):
        keys[i] = jax.random.key(i)                       # local: seed + i
        keys[node_seed(0, i)] = jax.random.fold_in(jax.random.key(0), i)
    table = {s: jax.tree_util.tree_map(np.asarray, jmodel.init_fn(k))
             for s, k in keys.items()}
    tmodel = dataclasses.replace(
        tabular.make_mlp_classifier(SIZES, "binary", device="cpu"),
        init_fn=lambda seed: tabular_params_from_jax(table[seed],
                                                     device="cpu"))
    data = dict(seed=0, n_total=400, n_silos=H, n_features=16)
    return dict(
        jmodel=jmodel, tmodel=tmodel,
        jsilos=jarms.normalize_participants(
            jsynthetic.make_gemini_like(**data)),
        tsilos=arms.normalize_participants(synthetic.make_gemini_like(**data)),
        ref={})


def cfg(sigma=0.0, *, port=True, **kw):
    """3 rounds (node arms: 3 local steps), batch 32, lr 0.5, C 1.0,
    microbatch 8, SecAgg off unless asked for."""
    mod, dpc = (arms, dp.DPConfig) if port else (jarms, JDPConfig)
    base = dict(rounds=3, batch_size=32, lr=0.5, use_secagg=False,
                gossip_steps=3,
                dp=dpc(clip_norm=1.0, noise_multiplier=sigma,
                       microbatch_size=8))
    base.update(kw)
    return mod.ArmConfig(**base)


def case_id(case) -> str:
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def max_diff(port_params, jax_params) -> float:
    """max |port - reference| over every leaf."""
    ours = jax.tree_util.tree_leaves(tabular_params_to_numpy(port_params))
    ref = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jax_params))
    assert len(ours) == len(ref)
    return max(float(np.max(np.abs(a - b))) for a, b in zip(ours, ref))


def trace(mod, dropout=None):
    """``heterogeneous_trace(H)`` of package ``mod`` as fresh nodes (their
    ``online`` flag is run state), hospital i off from t_off to t_on if
    ``dropout = (i, t_off, t_on)`` is given."""
    tr = mod.heterogeneous_trace(H)
    if dropout is not None:
        i, t_off, t_on = dropout
        tr[i] = dict(tr[i], dropouts=[[t_off, t_on]])
    return mod.nodes_from_trace(tr)


def check_sim_runner(setup, case, dropout):
    """One arm on one trace in both packages' ``SimRunner``: ``SimTiming``
    equal field for field, rounds and logs equal, parameters within 1e-5
    (sigma = 0).  The leaders rotate (``round_robin``): DeCaPH's uniform
    draw is the port's own."""
    name, kw = case
    kw = dict(kw, leader_strategy="round_robin")
    ours = arms.run(name, setup["tmodel"], setup["tsilos"], cfg(**kw),
                    backend="sim", nodes=trace(sim, dropout))
    ref = jarms.run(name, setup["jmodel"], setup["jsilos"],
                    cfg(port=False, **kw), backend="sim",
                    nodes=trace(jsim, dropout))
    assert dataclasses.asdict(ours.timing) == dataclasses.asdict(ref.timing)
    assert ours.rounds_completed == ref.rounds_completed
    assert [(l.round, l.leader, l.aggregate_batch) for l in ours.logs] == \
        [(l.round, l.leader, l.aggregate_batch) for l in ref.logs]
    assert max_diff(ours.params, ref.params) <= ROUND_ATOL
    assert len(ours.per_node_params or []) == len(ref.per_node_params or [])
    for a, b in zip(ours.per_node_params or [], ref.per_node_params or []):
        assert max_diff(a, b) <= ROUND_ATOL
    return ours

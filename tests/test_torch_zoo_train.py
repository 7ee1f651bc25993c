"""DP training of the model zoo's decoders in repro_torch against the JAX
reference, on the CPU, in float32.

Ghost clipping on the dense four (``olmo-1b`` with its non-parametric
LayerNorm, ``gemma-7b``, ``nemotron-4-340b`` and ``qwen2-vl-2b`` with
M-RoPE and the vision stub; heads untied, as the reference's
``tests/test_ghost_transformer.py`` runs them) against
``repro.core.ghost``: per-example losses at rtol 1e-5, norms at rtol 5e-5
(pad rows exactly 0), clipped sums at atol 1e-5 (``test_torch_ghost.py``'s
limits).  DeCaPH rounds through ``arms.run`` on OLMo (ghost clipping) and
Qwen3-30B-A3B (MoE: the faithful per-example path, ``torch.func.vmap``
through the dispatch) against ``repro.arms.run``: at sigma = 0 within 1e-5
(``test_torch_decaph.py``'s limit), and ε and the privacy ledger bit for
bit at sigma = 0.8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro.obs as jobs
import repro_torch.arms as arms
import repro_torch.obs as obs
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import ghost as jghost
from repro.core.dp import DPConfig as JDPConfig
from repro.models import transformer as jtf
from repro.serve.federation import token_silos as jax_token_silos
from repro.serve.federation import transformer_model as jax_transformer_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import dp
from repro_torch.core import ghost as tghost
from repro_torch.serve.federation import token_silos, transformer_model

torch.set_num_threads(1)

GHOST = ["olmo-1b", "gemma-7b", "nemotron-4-340b", "qwen2-vl-2b"]
MOE = "qwen3-moe-30b-a3b"
LOSS_RTOL = 1e-5
NORMS_RTOL = 5e-5
ATOL = 1e-5


def _untied(arch):
    return (jax_smoke_config(arch).replace(tie_embeddings=False),
            get_smoke_config(arch).replace(tie_embeddings=False))


def _trees_close(port_tree, cfg, jax_tree, atol) -> None:
    ours = jax.tree_util.tree_leaves(params_to_numpy(port_tree, cfg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jax_tree))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


# -- ghost clipping --------------------------------------------------------------


def _ghost_batch(cfg, arch, vision: bool):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (6, 10)).astype(np.int32)
    tokens[0, 2:8] = 5                              # a repeated token
    labels = rng.integers(0, cfg.vocab_size, (6, 10)).astype(np.int32)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if vision:
        batch["vision_embeds"] = rng.standard_normal(
            (6, 4, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = rng.integers(
            0, 32, (6, 14, 3)).astype(np.int32)     # distinct (t, h, w)
    return batch


@pytest.mark.parametrize("arch,vision", [(a, False) for a in GHOST]
                         + [("qwen2-vl-2b", True)])
def test_ghost_norms_and_clipped_sums_match_reference(arch, vision):
    jcfg, tcfg = _untied(arch)
    jparams = jtf.init(jcfg, jax.random.key(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    batch = _ghost_batch(tcfg, arch, vision)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    per_ex, _ = tghost.forward_ghost(tcfg, tparams, tb, torch.zeros(6),
                                     with_norms=False)
    jper_ex, _ = jghost.forward_ghost(jcfg, jparams, jb, jnp.zeros((6,)),
                                      with_norms=False)
    np.testing.assert_allclose(per_ex.detach().numpy(), np.asarray(jper_ex),
                               rtol=LOSS_RTOL)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    grads, loss, norms = tghost.ghost_clipped_grad_sum(
        tcfg, tparams, tb, clip_norm=0.5, mask=torch.from_numpy(mask))
    jgrads, jloss, jnorms = jghost.ghost_clipped_grad_sum(
        jcfg, jparams, jb, clip_norm=0.5, mask=jnp.asarray(mask))
    np.testing.assert_allclose(norms.numpy()[:4], np.asarray(jnorms)[:4],
                               rtol=NORMS_RTOL)
    np.testing.assert_array_equal(norms.numpy()[4:], 0.0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _trees_close(grads, tcfg, jgrads, ATOL)


@pytest.mark.parametrize("arch,tied,ghost", [
    ("olmo-1b", False, True), ("olmo-1b", True, False),
    ("nemotron-4-340b", False, True), (MOE, False, False)])
def test_ghost_capability_follows_the_reference(arch, tied, ghost):
    """Untied dense stacks clip through ghost norms; tied heads (an upper
    bound) and MoE (a dispatch mixes examples) clip per example."""
    jcfg, tcfg = (c.replace(tie_embeddings=tied)
                  for c in (jax_smoke_config(arch), get_smoke_config(arch)))
    assert (transformer_model(tcfg, device="cpu").ghost is not None) == ghost
    assert (jax_transformer_model(jcfg).ghost is not None) == ghost
    assert tghost._supported(tcfg) == jghost._supported(jcfg)


# -- DeCaPH rounds ---------------------------------------------------------------


@pytest.fixture(scope="module", params=["olmo-1b", MOE])
def lm(request):
    arch = request.param
    jcfg, tcfg = _untied(arch)
    jmodel = jax_transformer_model(jcfg)
    p0 = jax.tree_util.tree_map(np.asarray, jmodel.init_fn(jax.random.key(0)))
    tmodel = dataclasses.replace(transformer_model(tcfg, device="cpu"),
                                 init_fn=lambda seed: params_from_jax(
                                     p0, tcfg, device="cpu"))
    return dict(
        arch=arch, tcfg=tcfg, jmodel=jmodel, tmodel=tmodel,
        jsilos=jax_token_silos(jcfg, hospitals=3, n_per=8, seq_len=8,
                               seed=0),
        tsilos=token_silos(tcfg, hospitals=3, n_per=8, seq_len=8, seed=0),
    )


def _run(lm, sigma, *, port=True):
    mod, dpc = (arms, dp.DPConfig) if port else (jarms, JDPConfig)
    cfg = mod.ArmConfig(rounds=2, batch_size=6, lr=0.05, use_secagg=False,
                        dp=dpc(clip_norm=1.0, noise_multiplier=sigma,
                               microbatch_size=4))
    if port:
        return arms.run("decaph", lm["tmodel"], lm["tsilos"], cfg)
    return jarms.run("decaph", lm["jmodel"], lm["jsilos"], cfg)


def test_sigma0_rounds_match_reference(lm):
    ours, ref = _run(lm, 0.0), _run(lm, 0.0, port=False)
    assert ours.rounds_completed == ref.rounds_completed == 2
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=1e-5)
    _trees_close(ours.params, lm["tcfg"], ref.params, ATOL)


def test_epsilon_and_ledger_are_bit_identical(lm):
    with obs.recording() as rec:
        ours = _run(lm, 0.8)
        rows = rec.ledger.entries()
    with jobs.recording() as jrec:
        ref = _run(lm, 0.8, port=False)
        jrows = jrec.ledger.entries()
    assert rows and rows == jrows
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]

"""repro_torch ghost clipping against the JAX reference, on the CPU.

``smollm-360m`` smoke with untied embeddings (the reference's "lm" preset
family), float32, the reference's parameters carried across with
``params_from_jax``.  Tolerances:

  * losses at rtol 1e-5 (``tests/test_ghost_transformer.py``);
  * per-example norms at rtol 5e-5, pad rows exactly 0
    (``tests/test_ghost_fused.py``);
  * clipped gradient sums at atol 1e-5: the same sums, with float32 sums
    ordered differently by the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.arms as arms
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import dp as jdp
from repro.core import ghost as jghost
from repro.models import transformer as jtf
from repro_torch.arms import clipping
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import dp as tdp
from repro_torch.core import ghost as tghost
from repro_torch.models import transformer as ttf
from repro_torch.serve.federation import token_silos, transformer_model

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
NORMS_RTOL = 5e-5
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_smoke_config("smollm-360m").replace(tie_embeddings=False)
    tcfg = get_smoke_config("smollm-360m").replace(tie_embeddings=False)
    jparams = jtf.init(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (6, 12)).astype(np.int32)
    tokens[0, 3:9] = 5                      # a repeated token
    labels = rng.integers(0, tcfg.vocab_size, (6, 12)).astype(np.int32)
    labels[:, -1] = -1                      # a masked position
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                tokens=tokens, labels=labels, mask=mask)


def _jbatch(lm):
    return {"tokens": jnp.asarray(lm["tokens"]),
            "labels": jnp.asarray(lm["labels"])}


def _tbatch(lm):
    return {"tokens": torch.from_numpy(lm["tokens"]),
            "labels": torch.from_numpy(lm["labels"])}


def _assert_trees_close(port_tree, jax_tree, cfg, atol):
    ours = jax.tree_util.tree_leaves(params_to_numpy(port_tree, cfg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jax_tree))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_loss_matches_reference(lm):
    jb, tb = _jbatch(lm), _tbatch(lm)
    ref = float(jtf.loss_fn(lm["jcfg"], lm["jparams"], jb))
    np.testing.assert_allclose(float(ttf.loss_fn(lm["tcfg"], lm["tparams"],
                                                 tb)), ref, rtol=LOSS_RTOL)
    per_ex, _ = tghost.forward_ghost(lm["tcfg"], lm["tparams"], tb,
                                     torch.zeros(6), with_norms=False)
    jper_ex, _ = jghost.forward_ghost(lm["jcfg"], lm["jparams"], jb,
                                      jnp.zeros((6,)), with_norms=False)
    np.testing.assert_allclose(per_ex.detach().numpy(), np.asarray(jper_ex),
                               rtol=LOSS_RTOL)
    # the ghost loss is the model's loss (real rows, unmasked mean)
    np.testing.assert_allclose(float(per_ex.mean()), ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("chunk", [None, 2])
def test_norms_and_clipped_sums_match_reference(lm, chunk):
    mask = lm["mask"]
    grads, loss, norms = tghost.ghost_clipped_grad_sum(
        lm["tcfg"], lm["tparams"], _tbatch(lm), clip_norm=0.5,
        chunk_size=chunk, mask=torch.from_numpy(mask))
    jgrads, jloss, jnorms = jghost.ghost_clipped_grad_sum(
        lm["jcfg"], lm["jparams"], _jbatch(lm), clip_norm=0.5,
        chunk_size=chunk, mask=jnp.asarray(mask))
    np.testing.assert_allclose(norms.numpy()[:4], np.asarray(jnorms)[:4],
                               rtol=NORMS_RTOL)
    np.testing.assert_array_equal(norms.numpy()[4:], 0.0)   # pad rows
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(grads, jgrads, lm["tcfg"], GRAD_ATOL)


def test_norms_match_per_example_gradients(lm):
    """Ghost norms == the norms of literally computed per-example grads."""
    cfg, params = lm["tcfg"], lm["tparams"]
    _, _, norms = tghost.ghost_clipped_grad_sum(
        cfg, params, _tbatch(lm), clip_norm=1.0,
        mask=torch.from_numpy(lm["mask"]))
    for i in range(4):
        ex = {"tokens": torch.from_numpy(lm["tokens"][i]),
              "labels": torch.from_numpy(lm["labels"][i])}
        g = torch.func.grad(
            lambda p: ttf.per_example_loss_fn(cfg, p, ex))(params)
        np.testing.assert_allclose(float(norms[i]),
                                   float(tdp.global_l2_norm(g)),
                                   rtol=NORMS_RTOL)


def test_ghost_matches_faithful_clipped_sum(lm):
    """The port's two clipping paths give the same clipped sum, and the
    faithful path matches the reference's faithful path."""
    cfg, params = lm["tcfg"], lm["tparams"]
    mask = torch.from_numpy(lm["mask"])
    ghost, _, _ = tghost.ghost_clipped_grad_sum(cfg, params, _tbatch(lm),
                                                clip_norm=0.5, mask=mask)
    batch = {"x": torch.from_numpy(lm["tokens"]),
             "y": torch.from_numpy(lm["labels"])}
    model = transformer_model(cfg, device="cpu")
    faithful, loss = tdp.per_example_clipped_grad_sum(
        model.loss_fn, params, batch, clip_norm=0.5, microbatch_size=4,
        mask=mask)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(ghost, cfg)),
                    jax.tree_util.tree_leaves(params_to_numpy(faithful,
                                                              cfg))):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0)
    jcfg = lm["jcfg"]
    jfaithful, jloss = jdp.per_example_clipped_grad_sum(
        lambda p, ex: jtf.per_example_loss_fn(
            jcfg, p, {"tokens": ex["x"], "labels": ex["y"]}),
        lm["jparams"], {"x": jnp.asarray(lm["tokens"]),
                        "y": jnp.asarray(lm["labels"])},
        clip_norm=0.5, microbatch_size=4, mask=jnp.asarray(lm["mask"]))
    _assert_trees_close(faithful, jfaithful, cfg, GRAD_ATOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


def test_embed_norm_groups_repeated_tokens():
    """Repeated tokens add their cotangents into one embedding row before
    the square: against an explicit scatter-add and the reference's."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 5, (3, 17))            # many repeats
    tokens[1] = 2                                   # one token throughout
    g = rng.standard_normal((3, 17, 6)).astype(np.float32)
    explicit = []
    for b in range(3):
        rows = np.zeros((5, 6), np.float64)
        np.add.at(rows, tokens[b], g[b].astype(np.float64))
        explicit.append(np.sum(rows ** 2))
    ours = tghost._per_example_embed_norm(torch.from_numpy(tokens),
                                          torch.from_numpy(g))
    ref = jax.vmap(jghost._per_example_embed_norm)(jnp.asarray(tokens),
                                                   jnp.asarray(g))
    np.testing.assert_allclose(ours.numpy(), explicit, rtol=1e-6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=NORMS_RTOL)


def test_dp_dense_backward_and_promotion():
    """dp_dense's backward gives autograd's gradients, and a bfloat16
    activation times float32 weights promotes as the reference does."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((2, 5, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    a1, w1 = a.clone().requires_grad_(), w.clone().requires_grad_()
    coll = torch.zeros(2, requires_grad=True)
    y, coll_out = tghost.dp_dense(a1, w1, coll)
    ga, gw, gc = torch.autograd.grad((y.square().sum(), coll_out),
                                     (a1, w1, coll),
                                     (torch.tensor(1.0), torch.ones(2)))
    a2, w2 = a.clone().requires_grad_(), w.clone().requires_grad_()
    ra, rw = torch.autograd.grad((a2 @ w2).square().sum(), (a2, w2))
    torch.testing.assert_close(ga, ra)
    torch.testing.assert_close(gw, rw)
    per_ex = [torch.sum(torch.square(a[i].T @ (2 * (a[i] @ w))))
              for i in range(2)]
    torch.testing.assert_close(gc, 1 + torch.stack(per_ex), rtol=1e-5,
                               atol=1e-5)
    y16, _ = tghost.dp_dense(a.bfloat16(), w, torch.zeros(2))
    assert y16.dtype == torch.float32
    # 2-D inputs take the closed form |a_i|^2 |g_i|^2 (the outer product)
    a2d = a[:, 0].clone().requires_grad_()
    coll = torch.zeros(2, requires_grad=True)
    y, coll_out = tghost.dp_dense(a2d, w, coll)
    (gc,) = torch.autograd.grad((y.sum(), coll_out), (coll,),
                                (torch.tensor(1.0), torch.ones(2)))
    outer = [torch.sum(torch.square(torch.outer(a[i, 0], torch.ones(3))))
             for i in range(2)]
    torch.testing.assert_close(gc, 1 + torch.stack(outer))


def test_ghost_on_tied_model_raises():
    cfg = get_smoke_config("smollm-360m")                   # tied head
    tied = transformer_model(cfg, device="cpu")
    assert tied.ghost is None
    untied = transformer_model(cfg.replace(tie_embeddings=False), device="cpu")
    assert untied.ghost is not None
    acfg = arms.ArmConfig(rounds=1, batch_size=4, use_secagg=False,
                          clipping="ghost")
    assert clipping.resolve(tied, arms.ArmConfig(use_secagg=False)) \
        == "per-example"
    assert clipping.resolve(untied, arms.ArmConfig(use_secagg=False)) \
        == "ghost"
    silos = token_silos(cfg, hospitals=2, n_per=4, seq_len=6, seed=0)
    with pytest.raises(ValueError, match="GhostCapability"):
        arms.run("decaph", tied, silos, acfg)
    with pytest.raises(ValueError, match="clipping mode"):
        clipping.resolve(untied, arms.ArmConfig(clipping="bogus"))

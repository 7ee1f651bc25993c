"""repro_torch's ``use_flash`` route against the JAX reference, on the CPU.

With ``cfg.use_flash`` the reference sends causal attention on a TPU to its
Pallas flash kernel and everything else to ``_sdpa_blocked``; the port
reads "tpu" as "cuda".  On the CPU both packages therefore run
``_sdpa_blocked``, which these tests hold together:

  * ``_sdpa_blocked`` itself, values and gradients, at atol 1e-5 in
    float32 (a ``block_k`` that does not divide L, a window, non-causal);
  * the full-sequence forward and ``predict_fn`` of the ``smollm-360m``
    smoke config at S = 520 (two KV blocks of 512, the second padded):
    logits within 1e-4 (``tests/test_torch_model.py``'s whole-step
    tolerance), identical predicted tokens;
  * ghost norms and clipped sums with S > ``block_k``, at
    ``tests/test_torch_ghost.py``'s tolerances (norms rtol 5e-5 with pad
    rows exactly 0, gradients atol 1e-5, loss rtol 1e-5);
  * one sigma = 0 DeCaPH round within 1e-5 of the reference's.

The reference's parameters cross to the port with ``params_from_jax``;
other inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro_torch.arms as arms
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import ghost as jghost
from repro.core.dp import DPConfig as JDPConfig
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve.federation import token_silos as jax_token_silos
from repro.serve.federation import transformer_model as jax_transformer_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import dp as tdp
from repro_torch.core import ghost as tghost
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve.federation import token_silos, transformer_model

torch.set_num_threads(1)

ATOL = 1e-5          # float32 training numerics
ATOL_STEP = 1e-4     # a whole forward (tests/test_torch_model.py)
NORMS_RTOL = 5e-5
LOSS_RTOL = 1e-5
SEQ = 520            # two KV blocks of _sdpa_blocked's 512, one padded


# -- _sdpa_blocked ----------------------------------------------------------------


@pytest.mark.parametrize("s,l,h,kv,causal,window,bk", [
    (100, 100, 4, 2, True, None, 32),     # block_k does not divide L
    (256, 256, 4, 2, True, 64, 128),      # a window
    (64, 64, 4, 2, False, None, 48),      # non-causal, padded
    (96, 160, 6, 3, True, 40, 64),        # L > S, window, padded
    (80, 80, 4, 1, False, 24, 80),        # MQA, non-causal window, 1 block
])
def test_sdpa_blocked_matches_reference(s, l, h, kv, causal, window, bk):
    rng = np.random.default_rng(s + l)
    q = rng.standard_normal((2, s, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, l, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, l, kv, 16)).astype(np.float32)
    w = rng.standard_normal((2, s, h, 16)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jattn._sdpa_blocked(q_, k_, v_, causal=causal, window=window,
                                  block_k=bk)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn._sdpa_blocked(tq, tk, tv, causal=causal, window=window,
                              block_k=bk)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    for ours, ref in zip(grads, jgrads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)


def test_sdpa_blocked_under_torch_func_matches_plain_autograd():
    """Inside ``torch.func`` transforms (the faithful per-example path) the
    blocks run without the checkpoint, with the same gradients."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 40, 4, 16)).astype(
        np.float32)) for _ in range(3))
    kv_k, kv_v = k[:, :, :2], v[:, :, :2]

    def loss(q_, k_, v_):
        out = tattn._sdpa_blocked(q_[None], k_[None], v_[None], block_k=16)
        return torch.sum(out ** 2)

    per_ex = torch.func.vmap(torch.func.grad(loss))(q, kv_k, kv_v)
    for i in range(3):
        qi = q[i].clone().requires_grad_()
        (ref,) = torch.autograd.grad(loss(qi, kv_k[i], kv_v[i]), (qi,))
        torch.testing.assert_close(per_ex[i], ref, atol=1e-6, rtol=1e-6)


# -- the model: forward, predict, ghost norms, a round -----------------------------


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_smoke_config("smollm-360m").replace(tie_embeddings=False,
                                                   use_flash=True)
    tcfg = get_smoke_config("smollm-360m").replace(tie_embeddings=False,
                                                   use_flash=True)
    jparams = jtf.init(jcfg, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (4, SEQ)).astype(np.int32)
    tokens[0, 3:40] = 5                     # a repeated token
    labels = np.full_like(tokens, -1)
    labels[:, :-1] = tokens[:, 1:]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, np_params=np_params,
                tparams=params_from_jax(np_params, tcfg, device="cpu"),
                tokens=tokens, labels=labels)


def test_forward_matches_reference(lm):
    before = flash_ops.launches()
    logits, _ = ttf.forward(lm["tcfg"], lm["tparams"],
                            {"tokens": torch.from_numpy(lm["tokens"])})
    jlogits, _ = jtf.forward(lm["jcfg"], lm["jparams"],
                             {"tokens": jnp.asarray(lm["tokens"])})
    assert flash_ops.launches() == before     # CPU tensors: _sdpa_blocked
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_STEP, rtol=0)
    # use_flash changes the route, not the function
    plain, _ = ttf.forward(lm["tcfg"].replace(use_flash=False),
                           lm["tparams"],
                           {"tokens": torch.from_numpy(lm["tokens"])})
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), atol=ATOL_STEP,
                               rtol=0)


def test_predict_fn_gives_the_references_tokens(lm):
    ours = transformer_model(lm["tcfg"], device="cpu").predict_fn(
        lm["tparams"], torch.from_numpy(lm["tokens"]))
    ref = jax_transformer_model(lm["jcfg"]).predict_fn(
        lm["jparams"], jnp.asarray(lm["tokens"]))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_ghost_norms_and_clipped_sums_match_reference(lm):
    mask = np.array([1, 1, 1, 0], np.float32)
    grads, loss, norms = tghost.ghost_clipped_grad_sum(
        lm["tcfg"], lm["tparams"],
        {"tokens": torch.from_numpy(lm["tokens"]),
         "labels": torch.from_numpy(lm["labels"])},
        clip_norm=0.5, mask=torch.from_numpy(mask))
    jgrads, jloss, jnorms = jghost.ghost_clipped_grad_sum(
        lm["jcfg"], lm["jparams"],
        {"tokens": jnp.asarray(lm["tokens"]),
         "labels": jnp.asarray(lm["labels"])},
        clip_norm=0.5, mask=jnp.asarray(mask))
    np.testing.assert_allclose(norms.numpy()[:3], np.asarray(jnorms)[:3],
                               rtol=NORMS_RTOL)
    np.testing.assert_array_equal(norms.numpy()[3:], 0.0)     # the pad row
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    ours = jax.tree_util.tree_leaves(params_to_numpy(grads, lm["tcfg"]))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_faithful_clipped_sum_with_use_flash_matches_ghost(lm):
    """The per-example path (torch.func) runs _sdpa_blocked too."""
    cfg, params = lm["tcfg"], lm["tparams"]
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
    x, y = (torch.from_numpy(lm[n][:, :SEQ // 4]) for n in ("tokens",
                                                            "labels"))
    model = transformer_model(cfg, device="cpu")
    faithful, _ = tdp.per_example_clipped_grad_sum(
        model.loss_fn, params, {"x": x, "y": y}, clip_norm=0.5,
        microbatch_size=2, mask=mask)
    ghost, _, _ = tghost.ghost_clipped_grad_sum(
        cfg, params, {"tokens": x, "labels": y}, clip_norm=0.5, mask=mask)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(faithful, cfg)),
                    jax.tree_util.tree_leaves(params_to_numpy(ghost, cfg))):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_sigma0_round_matches_reference(lm):
    jmodel = jax_transformer_model(lm["jcfg"])
    tmodel = dataclasses.replace(
        transformer_model(lm["tcfg"], device="cpu"),
        init_fn=lambda seed: params_from_jax(lm["np_params"], lm["tcfg"],
                                             device="cpu"))
    jmodel = dataclasses.replace(jmodel, init_fn=lambda key: lm["jparams"])
    silos = dict(hospitals=2, n_per=4, seq_len=SEQ, seed=0)

    def cfg(port):
        mod, dpc = (arms, tdp.DPConfig) if port else (jarms, JDPConfig)
        return mod.ArmConfig(rounds=1, batch_size=4, lr=0.05,
                             use_secagg=False,
                             dp=dpc(clip_norm=1.0, noise_multiplier=0.0))

    ours = arms.run("decaph", tmodel, token_silos(lm["tcfg"], **silos),
                    cfg(True))
    ref = jarms.run("decaph", jmodel, jax_token_silos(lm["jcfg"], **silos),
                    cfg(False))
    assert ours.rounds_completed == ref.rounds_completed == 1
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=LOSS_RTOL)
    a = jax.tree_util.tree_leaves(params_to_numpy(ours.params, lm["tcfg"]))
    b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                         ref.params))
    assert max(float(np.max(np.abs(x - y))) for x, y in zip(a, b)) <= ATOL
    # and the round moved the parameters
    assert max(float(np.max(np.abs(x - y))) for x, y in zip(
        a, jax.tree_util.tree_leaves(lm["np_params"]))) > 0

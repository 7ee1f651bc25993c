"""DeepSeek-V3 in repro_torch — MLA (absorbed decode), multi-token
prediction and the dense-then-MoE stack — against the JAX reference, on the
CPU, in float32.

The smoke config (1 dense + 1 MoE layer of MLA) with the reference's
weights carried across by ``convert.params_from_jax`` and inputs from a
numpy seed.  Tolerances: the MLA layer and its decode at 1e-5; forwards,
decode steps and prefills at 1e-4 (float32 sums ordered differently over
the layers and a 512-way head); losses and every gradient leaf at 1e-5;
greedy engine tokens and the checkpoint files bit for bit; one faithful
DeCaPH round at sigma 0 within 1e-5 and epsilon bit-identical at sigma 0.8.
The forward and decode checks run at ``capacity_factor = n_experts``, as
the reference's own ``test_decode_matches_forward`` does, so no choice is
dropped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro_torch.arms as arms
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import active_param_count as jax_active_param_count
from repro.configs.base import param_count as jax_param_count
from repro.core.dp import DPConfig as JDPConfig
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve.federation import token_silos as jax_token_silos
from repro.serve.federation import transformer_model as jax_transformer_model
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import LayerSpec, active_param_count, param_count
from repro_torch.convert import (
    cache_to_numpy,
    params_from_jax,
    params_from_tree,
    params_to_numpy,
    params_to_tree,
)
from repro_torch.core import dp
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.serve.federation import token_silos, transformer_model

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
ATOL_LAYER = 1e-5
ATOL_STEP = 1e-4
ATOL_DP = 1e-5


def _pair(**kw):
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    kw.setdefault("capacity_factor", float(tcfg.n_experts))
    return jcfg.replace(**kw), tcfg.replace(**kw)


@pytest.fixture(scope="module")
def model():
    """The reference's smoke parameters with the MTP subtree, and the
    port's copy."""
    jcfg, tcfg = _pair(mtp_depth=1)
    jparams = jtf.init(jcfg, jax.random.key(7))
    tree = jax.tree_util.tree_map(np.array, jparams)
    # the norms' scales at random, so a swapped scale shows
    rng = np.random.default_rng(0)
    for group in ("group0", "group1"):
        mixer = tree[group]["e0"]["mixer"]
        for key in mixer:
            if key.split("|")[0] in ("q_norm_scale", "kv_norm_scale"):
                mixer[key] = rng.uniform(0.5, 1.5, mixer[key].shape).astype(
                    np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_jax(tree, tcfg, device="cpu")


def _plain(jcfg, tcfg, jparams, tparams):
    """The same model without MTP (the configs, and params without the
    subtree)."""
    return (jcfg.replace(mtp_depth=0), tcfg.replace(mtp_depth=0),
            {k: v for k, v in jparams.items() if k != "mtp"},
            {k: v for k, v in tparams.items() if k != "mtp"})


def _close(ours, ref, atol=ATOL_STEP):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def _fields(cfg) -> dict:
    return {**vars(cfg), "stack": [(r, [dataclasses.astuple(s) for s in p])
                                   for r, p in cfg.stack]}


def _torch_tree(jtree):
    """A tree of JAX arrays as tensors of the same dtypes."""
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            getattr(torch, str(a.dtype))), jtree)


def _batch(cfg, rng, b=2, s=11):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -1] = -1
    return ({k: jnp.asarray(v) for k, v in (("tokens", tokens),
                                            ("labels", labels))},
            {k: torch.from_numpy(v) for k, v in (("tokens", tokens),
                                                 ("labels", labels))})


# -- config and layout --------------------------------------------------------------


def test_configs_and_param_counts_are_the_references():
    for ours, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert _fields(ours) == _fields(ref)
        assert param_count(ours) == jax_param_count(ref)
        assert active_param_count(ours) == jax_active_param_count(ref)
        ttf.check_supported(ours)
        ttf.check_supported(ours.replace(mtp_depth=1))
    full = get_config(ARCH)
    assert param_count(full) == 671_025_397_760
    # what chip_smoke.py's phase 23 runs: the 3 dense layers and 2 (or, in
    # float32, 1) of the 58 MoE layers
    for moe, n in ((2, 26_618_298_368), (1, 15_111_028_736)):
        cut = full.replace(n_layers=3 + moe, stack=(
            full.stack[0], (moe, (LayerSpec("mla", "moe"),))))
        assert param_count(cut) == n
    assert not ttf.is_flat(full)


def test_init_has_the_converted_layout_and_dtypes(model):
    """The port's own draw has the converted tree's shapes (the two
    groups, the MTP subtree); under bf16 the router stays float32, in the
    MTP block too."""
    jcfg, tcfg, _, tparams = model
    ours = ttf.init(tcfg, 0, "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams)
    assert ours["group0"]["e0"]["q_norm_scale"].eq(1).all()
    bf16 = ttf.init(tcfg.replace(param_dtype="bfloat16"), 0, "cpu")
    jbf16 = jtf.init(jcfg.replace(param_dtype="bfloat16"), jax.random.key(0))
    ours = [str(t.dtype)[6:] for t in jax.tree_util.tree_leaves(
        params_to_tree(bf16))]
    ref = [str(a.dtype) for a in jax.tree_util.tree_leaves(jbf16)]
    assert ours == ref and ours.count("float32") == 2


def test_params_cross_both_layouts_leaf_for_leaf(model):
    jcfg, tcfg, jparams, tparams = model
    ours = jax.tree_util.tree_leaves(params_to_numpy(tparams, tcfg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    assert len(ours) == len(ref)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    back = params_from_tree(params_to_tree(tparams), tcfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tparams)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_are_the_references_files_both_ways(model, tmp_path,
                                                         dtype):
    """A round published from the port (the MTP subtree and the float32
    routers included) is the reference's file byte for byte, and each
    package loads the other's."""
    jcfg, tcfg, _, _ = model
    jparams = jtf.init(jcfg.replace(param_dtype=dtype), jax.random.key(11))
    tparams = params_from_tree(_torch_tree(jparams), tcfg, "cpu")
    meta = {"arm": "decaph", "arch": ARCH}
    port, ref = tmp_path / "port.msgpack", tmp_path / "ref.msgpack"
    save_checkpoint(str(port), params_to_tree(tparams), step=3, metadata=meta)
    jsave(str(ref), jparams, step=3, metadata=meta)
    assert port.read_bytes() == ref.read_bytes()
    tree, step, got = load_checkpoint(str(ref))
    loaded = params_from_tree(tree, tcfg, "cpu")
    assert step == 3 and got == meta
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(tparams)))
    jtree, step, _ = jload(str(port))
    assert step == 3
    assert all(np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32)) and a.dtype == b.dtype
               for a, b in zip(jax.tree_util.tree_leaves(jtree),
                               jax.tree_util.tree_leaves(jparams)))


def test_cache_layout_is_the_references():
    """The compressed cache, ``attn`` = {"c", "kr"} in each group: 576
    values a token at V3's width, in the compute dtype."""
    jcfg, tcfg = _pair(compute_dtype="bfloat16")
    ours = ttf.init_cache(tcfg, 3, 8, "cpu")
    ref = jtf.init_cache(jcfg, 3, 8)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, ours)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, ref))
    assert [(tuple(t.shape), str(t.dtype)[6:])
            for t in jax.tree_util.tree_leaves(ours)] == \
        [(a.shape, str(a.dtype)) for a in jax.tree_util.tree_leaves(ref)]
    full = get_config(ARCH)
    assert full.kv_lora_rank + full.qk_rope_dim == 576


# -- the MLA layer ------------------------------------------------------------------


def _layer(model, group="group1"):
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams[group]["e0"]["mixer"])
    tp = {k: t[0] for k, t in tparams[group]["e0"].items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("window", [None, 4])
def test_mla_apply_matches_reference(model, window):
    jcfg, tcfg, jp, tp = _layer(model)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    positions = np.stack([np.arange(9), np.arange(3, 12)]).astype(np.int32)
    ref = jattn.mla_apply(jp, jnp.asarray(x), jnp.asarray(positions), jcfg,
                          window=window)
    ours = tattn.mla_apply(tp, torch.from_numpy(x),
                           torch.from_numpy(positions), tcfg, window=window)
    _close(ours, ref, ATOL_LAYER)


@pytest.mark.parametrize("window", [None, 3])
def test_mla_decode_rows_at_different_positions(model, window):
    """One absorbed decode step of 4 rows at positions 0, 5, 2 and 7 of an
    8-row cache, against the reference's vmap of one-row decodes (what its
    ``decode_step_positions`` does): outputs and both cache leaves, each
    row written at its own index."""
    jcfg, tcfg, jp, tp = _layer(model)
    rng = np.random.default_rng(2)
    b, l = 4, 8
    x = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
    c = rng.normal(size=(b, l, tcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(b, l, tcfg.qk_rope_dim)).astype(np.float32)
    index = np.array([0, 5, 2, 7], np.int32)

    def one(xr, cr, krr, i):
        y, cache = jattn.mla_decode(jp, xr[None], {"c": cr[None],
                                                   "kr": krr[None]}, i, jcfg,
                                    window=window)
        return y[0], cache["c"][0], cache["kr"][0]

    jy, jc, jkr = jax.vmap(one)(jnp.asarray(x), jnp.asarray(c),
                                jnp.asarray(kr), jnp.asarray(index))
    cache = {"c": torch.from_numpy(c.copy()), "kr": torch.from_numpy(kr.copy())}
    y, out = tattn.mla_decode(tp, torch.from_numpy(x), cache,
                              torch.from_numpy(index), tcfg, window=window)
    assert out is cache
    _close(y, jy, ATOL_LAYER)
    _close(cache["c"], jc, ATOL_LAYER)
    _close(cache["kr"], jkr, ATOL_LAYER)
    # rows other than each row's index are untouched
    keep = np.ones((b, l), bool)
    keep[np.arange(b), index] = False
    assert np.array_equal(cache["c"].numpy()[keep], c[keep])


def test_absorbed_decode_equals_the_full_sequence_layer(model):
    """Decoding the positions one by one through the compressed cache
    gives ``mla_apply``'s outputs (the absorption changes the order of
    the products, not the function)."""
    _, tcfg, _, tp = _layer(model, "group0")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 6, tcfg.d_model)).astype(np.float32))
    full = tattn.mla_apply(tp, x, torch.arange(6)[None].expand(2, 6), tcfg)
    cache = tattn.mla_init_cache(tcfg, 2, 6, torch.float32, "cpu")
    steps = [tattn.mla_decode(tp, x[:, t:t + 1], cache,
                              torch.full((2,), t, dtype=torch.int32),
                              tcfg)[0] for t in range(6)]
    _close(torch.cat(steps, dim=1), full, ATOL_LAYER)


# -- the stack ----------------------------------------------------------------------


def test_forward_and_loss_match_reference(model):
    jcfg, tcfg, jparams, tparams = _plain(*model)
    jb, tb = _batch(tcfg, np.random.default_rng(4))
    jlogits, jaux = jtf.forward(jcfg, jparams, jb)
    logits, aux = ttf.forward(tcfg, tparams, tb)
    _close(logits.detach(), jlogits)
    _close(float(aux), float(jaux), ATOL_DP)
    assert float(aux) > 0
    _close(float(ttf.loss_fn(tcfg, tparams, tb)),
           float(jtf.loss_fn(jcfg, jparams, jb)), ATOL_DP)


def test_mtp_loss_and_every_gradient_match_jax_grad(model):
    """``loss_fn`` with ``mtp_depth=1``: the loss above the loss without
    the MTP term, as the reference's ``test_extensions`` checks, and the
    loss and every leaf of its gradient (the ``mtp`` subtree included)
    against ``jax.grad``'s."""
    jcfg, tcfg, jparams, tparams = model
    jb, tb = _batch(tcfg, np.random.default_rng(5), b=2, s=12)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jb))(jparams)
    tp = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(),
                                tparams)
    loss = ttf.loss_fn(tcfg, tp, tb)
    leaves = jax.tree_util.tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves)
    _close(float(loss.detach()), float(jloss), ATOL_DP)
    _, tcfg0, _, tparams0 = _plain(*model)
    assert float(loss.detach()) > float(ttf.loss_fn(tcfg0, tparams0, tb))
    gtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tp), list(grads))
    ours = jax.tree_util.tree_leaves(params_to_numpy(gtree, tcfg))
    ref = jax.tree_util.tree_leaves(jgrad)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _close(a, b, ATOL_DP)
    assert any(np.abs(a).max() > 0 for a in jax.tree_util.tree_leaves(
        params_to_numpy(gtree, tcfg)["mtp"]))


def test_prefill_and_decode_steps_match_reference(model):
    """A 6-token prefill of 3 rows, ``decode_step_positions`` at ragged
    per-row positions and ``decode_step`` at one index: logits and both
    cache leaves of every layer."""
    jcfg, tcfg, jparams, tparams = _plain(*model)
    rng = np.random.default_rng(6)
    b, max_len = 3, 16
    prompt = rng.integers(0, tcfg.vocab_size, (b, 6)).astype(np.int32)
    jlogits, jcache = jtf.prefill(jcfg, jparams,
                                  jtf.init_cache(jcfg, b, max_len),
                                  jnp.asarray(prompt))
    logits, tcache = ttf.prefill(tcfg, tparams,
                                 ttf.init_cache(tcfg, b, max_len, "cpu"),
                                 torch.from_numpy(prompt))

    def same_caches():
        ours = jax.tree_util.tree_leaves(cache_to_numpy(tcache, tcfg))
        ref = jax.tree_util.tree_leaves(jcache)
        assert len(ours) == len(ref) == 4
        for a, r in zip(ours, ref):
            _close(a, r)

    _close(logits, jlogits)
    same_caches()
    tokens = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    positions = np.array([6, 2, 11], np.int32)
    jlogits, jcache = jtf.decode_step_positions(
        jcfg, jparams, jcache, jnp.asarray(tokens), jnp.asarray(positions))
    logits, tcache = ttf.decode_step_positions(
        tcfg, tparams, tcache, torch.from_numpy(tokens),
        torch.from_numpy(positions))
    _close(logits, jlogits)
    same_caches()
    jlogits, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(tokens), 12)
    logits, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(tokens), 12)
    _close(logits, jlogits)
    same_caches()


def test_decode_matches_forward(model):
    """Teacher-forced decode steps from an empty cache give the forward's
    logits at every position (the reference's own check of its stack)."""
    _, tcfg, _, tparams = _plain(*model)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32))
    full, _ = ttf.forward(tcfg, tparams, {"tokens": tokens})
    cache = ttf.init_cache(tcfg, 2, 9, "cpu")
    steps = [ttf.decode_step(tcfg, tparams, cache, tokens[:, t:t + 1], t)[0]
             for t in range(9)]
    _close(torch.cat(steps, dim=1), full.detach())


# -- serving and DP -----------------------------------------------------------------


def test_batch_generate_tokens_are_the_references(model):
    """The engines at the config's own capacity factor (1.25): each row is
    its own MoE group in both packages."""
    jcfg, tcfg, jparams, tparams = _plain(*model)
    jcfg, tcfg = (c.replace(capacity_factor=1.25) for c in (jcfg, tcfg))
    prompts = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (3, 5)).astype(np.int32)
    kw = dict(slots=3, max_len=16, temperature=0.0)
    ours = tengine.batch_generate(tengine.ServeEngine(
        tengine.ServeConfig(arch=ARCH, device="cpu", **kw), model_cfg=tcfg,
        params=tparams), prompts, 7)
    ref = jengine.batch_generate(jengine.ServeEngine(
        jengine.ServeConfig(arch=ARCH, **kw), model_cfg=jcfg,
        params=jparams), prompts, 7)
    np.testing.assert_array_equal(ours, np.asarray(ref))


def _rounds(model, sigma, port):
    jcfg, tcfg, jparams, _ = _plain(*model)
    jcfg, tcfg = (c.replace(capacity_factor=1.25) for c in (jcfg, tcfg))
    p0 = jax.tree_util.tree_map(np.asarray, jparams)
    kw = dict(rounds=1, batch_size=4, lr=0.05, use_secagg=False)
    dpkw = dict(clip_norm=1.0, noise_multiplier=sigma, microbatch_size=2)
    if port:
        tmodel = transformer_model(tcfg, device="cpu")
        assert tmodel.ghost is None          # MoE: the faithful path
        tmodel = dataclasses.replace(tmodel, init_fn=lambda seed: (
            params_from_jax(p0, tcfg, device="cpu")))
        return arms.run("decaph", tmodel, token_silos(
            tcfg, hospitals=2, n_per=4, seq_len=6, seed=0),
            arms.ArmConfig(dp=dp.DPConfig(**dpkw), **kw)), tcfg
    jmodel = dataclasses.replace(jax_transformer_model(jcfg),
                                 init_fn=lambda key: jparams)
    return jarms.run("decaph", jmodel, jax_token_silos(
        jcfg, hospitals=2, n_per=4, seq_len=6, seed=0),
        jarms.ArmConfig(dp=JDPConfig(**dpkw), **kw)), jcfg


def test_faithful_decaph_round_matches_reference(model):
    """One DeCaPH round at sigma 0 on the faithful per-example path
    (``torch.func.vmap`` of ``grad`` through MLA and the MoE dispatch)."""
    ours, tcfg = _rounds(model, 0.0, port=True)
    ref, _ = _rounds(model, 0.0, port=False)
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=1e-5)
    mine = jax.tree_util.tree_leaves(params_to_numpy(ours.params, tcfg))
    theirs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, ref.params))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        _close(a, b, ATOL_DP)


def test_epsilon_and_ledger_are_bit_identical(model):
    ours, _ = _rounds(model, 0.8, port=True)
    ref, _ = _rounds(model, 0.8, port=False)
    assert ours.epsilon == ref.epsilon
    assert [l.epsilon for l in ours.logs] == [l.epsilon for l in ref.logs]

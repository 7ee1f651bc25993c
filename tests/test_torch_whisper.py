"""Whisper-small in repro_torch — parametric LayerNorm, sinusoidal
positions, the encoder over stub frames and cross attention — against the
JAX reference, on the CPU, in float32.

The smoke config (2 encoder and 2 decoder layers, 64 frames) with the
reference's weights carried across by ``convert.params_from_jax`` and
inputs from a numpy seed.  Tolerances: ``layernorm`` at 1e-6 in float32;
in bfloat16 its scale and bias bit for bit, the whole norm within one bf16
ulp (see the test); ``sinusoidal_positions`` at 1e-6; the cross
attention and the encoder at 1e-5; forwards (with and without
``use_flash``, whose CPU route is ``_sdpa_blocked``) and decode steps at
1e-4; the loss at 1e-5; checkpoints bit for bit.  The decode writes each
layer's ``cross_kv_cache`` of ``_encode``'s output into the cache, as the
reference's ``test_decode_matches_forward`` does.  The serving engine
refuses the arch, as the reference's does.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import param_count as jax_param_count
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import param_count
from repro_torch.convert import (
    cache_to_numpy,
    params_from_jax,
    params_from_tree,
    params_to_numpy,
    params_to_tree,
)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ARCH = "whisper-small"
ATOL_LAYER = 1e-5
ATOL_STEP = 1e-4


@pytest.fixture(scope="module")
def model():
    """The reference's smoke parameters, the LayerNorms' scales and biases
    drawn at random so each counts, and the port's copy."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tree = jax.tree_util.tree_map(np.array, jtf.init(jcfg, jax.random.key(3)))
    rng = np.random.default_rng(0)

    def jitter(node):
        for key, val in node.items():
            if isinstance(val, dict):
                jitter(val)
            elif key.split("|")[0] in ("scale", "bias"):
                node[key] = (val + rng.uniform(-0.3, 0.3, val.shape)
                             ).astype(np.float32)

    jitter(tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_jax(tree, tcfg, device="cpu")


def _close(ours, ref, atol=ATOL_STEP):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def _fields(cfg) -> dict:
    return {**vars(cfg), "stack": [(r, [dataclasses.astuple(s) for s in p])
                                   for r, p in cfg.stack]}


def _frames(cfg, rng, b=2):
    return (0.05 * rng.normal(size=(b, cfg.n_audio_ctx, cfg.d_model))
            ).astype(np.float32)


def _batch(cfg, rng, b=2, s=10):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels, "frames": _frames(cfg, rng, b)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# -- config, layout, checkpoints ------------------------------------------------------


def test_configs_and_param_counts_are_the_references():
    for ours, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        assert _fields(ours) == _fields(ref)
        assert param_count(ours) == jax_param_count(ref)
        ttf.check_supported(ours)
        # one spec with cross attention: nested, as the reference's tree
        assert not ttf.is_flat(ours)
    assert param_count(get_config(ARCH)) == 238_013_184


def test_init_has_the_converted_layout(model):
    jcfg, tcfg, _, tparams = model
    ours = ttf.init(tcfg, 0, "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams)
    layer = ours["group0"]["e0"]
    assert layer["norm_cross"].eq(1).all() and layer["norm_cross_bias"].eq(0).all()
    assert set(ours) == {"embed", "final_norm", "final_norm_bias", "group0",
                         "encoder", "enc_final_norm", "enc_final_norm_bias"}
    bf16 = ttf.init(tcfg.replace(param_dtype="bfloat16"), 0, "cpu")
    assert {t.dtype for t in jax.tree_util.tree_leaves(bf16)} == \
        {torch.bfloat16}


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
    jcfg, tcfg, _, _ = model
    jparams = jtf.init(jcfg.replace(param_dtype=dtype), jax.random.key(5))
    tparams = params_from_tree(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            getattr(torch, str(a.dtype))), jparams), tcfg, "cpu")
    meta = {"arm": "decaph", "arch": ARCH}
    port, ref = tmp_path / "port.msgpack", tmp_path / "ref.msgpack"
    save_checkpoint(str(port), params_to_tree(tparams), step=2, metadata=meta)
    jsave(str(ref), jparams, step=2, metadata=meta)
    assert port.read_bytes() == ref.read_bytes()
    tree, step, got = load_checkpoint(str(ref))
    assert step == 2 and got == meta
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params_from_tree(tree, tcfg, "cpu")),
        jax.tree_util.tree_leaves(tparams)))
    jtree, _, _ = jload(str(port))
    assert all(np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32)) and a.dtype == b.dtype
               for a, b in zip(jax.tree_util.tree_leaves(jtree),
                               jax.tree_util.tree_leaves(jparams)))


def test_cache_layout_is_the_references():
    """``attn`` and ``cross`` K/V in each decoder layer, in the compute
    dtype, the cross ones [B, n_audio_ctx, KV, hd]."""
    jcfg, tcfg = (c.replace(compute_dtype="bfloat16") for c in
                  (jax_smoke_config(ARCH), get_smoke_config(ARCH)))
    ours = ttf.init_cache(tcfg, 3, 8, "cpu")
    ref = jtf.init_cache(jcfg, 3, 8)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, ours)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, ref))
    assert [(tuple(t.shape), str(t.dtype)[6:])
            for t in jax.tree_util.tree_leaves(ours)] == \
        [(a.shape, str(a.dtype)) for a in jax.tree_util.tree_leaves(ref)]


def test_the_engine_refuses_the_arch_as_the_references_does():
    with pytest.raises(ValueError, match="encoder-decoder") as ours:
        tengine.ServeEngine(tengine.ServeConfig(arch=ARCH, device="cpu"))
    with pytest.raises(ValueError, match="encoder-decoder") as ref:
        jengine.ServeEngine(jengine.ServeConfig(arch=ARCH))
    assert str(ours.value) == str(ref.value)


# -- layers ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """float32 within 1e-6.  bfloat16: the scale and bias bit for bit from
    the same normalised values (rounded to bf16 before the float32 scale
    and bias, as the reference does); the whole norm within one bf16 ulp,
    because the float32 variance and rsqrt of XLA and of torch differ by
    an ulp in some rows, and where that straddles a bf16 rounding edge the
    normalised value rounds the other way (1 of 16,896 values here)."""
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(4, 33, 128)) + 0.5).astype(np.float32)
    scale = rng.normal(size=128).astype(np.float32)
    bias = rng.normal(size=128).astype(np.float32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x, jt)
    ref = jl.layernorm({jl.pname("scale", "embed"): jnp.asarray(scale, jt),
                        jl.pname("bias", "embed"): jnp.asarray(bias, jt)}, jx)
    args = (torch.from_numpy(x).to(tt), torch.from_numpy(scale).to(tt),
            torch.from_numpy(bias).to(tt))
    ours = tl.layernorm(*args)
    assert ours.dtype == tt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        _close(ours, ref, 1e-6)
        return
    normed = torch.from_numpy(np.asarray(
        jl.layernorm_nonparam(jx).astype(jnp.float32))).to(tt)
    with mock.patch.object(tl, "layernorm_nonparam", lambda x, eps: normed):
        np.testing.assert_array_equal(tl.layernorm(*args).float().numpy(),
                                      ref)
    diff = np.abs(ours.float().numpy() - ref)
    assert np.all(diff <= 2.0 ** -7 * np.abs(ref))
    assert np.count_nonzero(diff) <= diff.size // 1000


@pytest.mark.parametrize("n,d", [(64, 128), (10, 32)])
def test_sinusoidal_positions_match_reference(n, d):
    _close(tl.sinusoidal_positions(n, d), jl.sinusoidal_positions(n, d), 1e-6)


def _layer(model):
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["group0"]["e0"])
    tp = {k: t[1] for k, t in tparams["group0"]["e0"].items()}
    return jcfg, tcfg, jp, tp


def test_cross_attention_matches_reference(model):
    """``cross_apply`` over the whole encoder output, and ``cross_decode``
    of one position over ``cross_kv_cache``."""
    jcfg, tcfg, jp, tp = _layer(model)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, tcfg.n_audio_ctx, tcfg.d_model)).astype(
        np.float32)
    ref = jattn.cross_apply(jp["cross"], jnp.asarray(x), jnp.asarray(enc),
                            jcfg)
    _close(tattn.cross_apply(tp, torch.from_numpy(x), torch.from_numpy(enc),
                             tcfg), ref, ATOL_LAYER)
    jkv = jattn.cross_kv_cache(jp["cross"], jnp.asarray(enc), jcfg)
    tkv = tattn.cross_kv_cache(tp, torch.from_numpy(enc), tcfg)
    for key in ("k", "v"):
        _close(tkv[key], jkv[key], ATOL_LAYER)
    ref = jattn.cross_decode(jp["cross"], jnp.asarray(x[:, :1]), jkv, jcfg)
    _close(tattn.cross_decode(tp, torch.from_numpy(x[:, :1]), tkv, tcfg), ref,
           ATOL_LAYER)


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_matches_reference(model, use_flash):
    jcfg, tcfg, jparams, tparams = model
    frames = _frames(tcfg, np.random.default_rng(3))
    ref = jtf._encode(jcfg.replace(use_flash=use_flash), jparams,
                      jnp.asarray(frames))
    _close(ttf._encode(tcfg.replace(use_flash=use_flash), tparams,
                       torch.from_numpy(frames)), ref, ATOL_LAYER)


# -- the stack --------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_and_loss_match_reference(model, use_flash):
    """The logits at 1e-4 and the loss at 1e-5; with ``use_flash`` both
    packages take ``_sdpa_blocked`` on the CPU, the encoder non-causal, the
    decoder causal (at S = 70, so the decoder's one block is ragged)."""
    jcfg, tcfg, jparams, tparams = model
    jcfg, tcfg = (c.replace(use_flash=use_flash) for c in (jcfg, tcfg))
    jb, tb = _batch(tcfg, np.random.default_rng(4), s=70 if use_flash else 10)
    jlogits, _ = jtf.forward(jcfg, jparams, jb)
    logits, aux = ttf.forward(tcfg, tparams, tb)
    _close(logits.detach(), jlogits)
    assert float(aux) == 0.0
    _close(float(ttf.loss_fn(tcfg, tparams, tb)),
           float(jtf.loss_fn(jcfg, jparams, jb)), ATOL_LAYER)


def _cross_caches(cfg, params, cache, frames, module):
    """Each decoder layer's ``cross`` K/V from one ``_encode`` of the
    frames, written into the cache: the reference's vmap over its layers,
    or the port's layers one by one (no API of its own)."""
    if module is jtf:
        enc = jtf._encode(cfg, params, frames)
        cache["group0"]["e0"]["cross"] = jax.vmap(
            lambda lp: jattn.cross_kv_cache(lp["e0"]["cross"], enc, cfg)
        )(params["group0"])
        return cache
    enc = ttf._encode(cfg, params, frames)
    for (_, p), c in zip(ttf.layers_of(cfg, params),
                         ttf.layer_caches(cfg, cache)):
        for key, t in tattn.cross_kv_cache(p, enc, cfg).items():
            c["cross"][key].copy_(t)
    return cache


def test_prefill_and_decode_steps_match_reference(model):
    """With the cross caches written: a 5-token prefill of 3 rows,
    ``decode_step_positions`` at ragged positions and ``decode_step`` at
    one index, with the decode kernel's route on, against the reference:
    logits and every cache leaf."""
    jcfg, tcfg, jparams, tparams = model
    jcfg, tcfg = (c.replace(use_decode_kernel=True) for c in (jcfg, tcfg))
    rng = np.random.default_rng(5)
    b, max_len = 3, 16
    frames = _frames(tcfg, rng, b)
    prompt = rng.integers(0, tcfg.vocab_size, (b, 5)).astype(np.int32)
    jcache = _cross_caches(jcfg, jparams, jtf.init_cache(jcfg, b, max_len),
                           jnp.asarray(frames), jtf)
    tcache = _cross_caches(tcfg, tparams,
                           ttf.init_cache(tcfg, b, max_len, "cpu"),
                           torch.from_numpy(frames), ttf)

    def same_caches():
        ours = jax.tree_util.tree_leaves(cache_to_numpy(tcache, tcfg))
        ref = jax.tree_util.tree_leaves(jcache)
        assert len(ours) == len(ref) == 4
        for a, r in zip(ours, ref):
            _close(a, r)

    same_caches()
    jlogits, jcache = jtf.prefill(jcfg, jparams, jcache, jnp.asarray(prompt))
    logits, tcache = ttf.prefill(tcfg, tparams, tcache,
                                 torch.from_numpy(prompt))
    _close(logits, jlogits)
    same_caches()
    tokens = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    positions = np.array([5, 2, 11], np.int32)
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
    """Teacher-forced decode steps over the cross caches give the
    forward's logits at every position."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(_frames(tcfg, rng))
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 9)
                                           ).astype(np.int32))
    full, _ = ttf.forward(tcfg, tparams, {"tokens": tokens, "frames": frames})
    cache = _cross_caches(tcfg, tparams, ttf.init_cache(tcfg, 2, 9, "cpu"),
                          frames, ttf)
    steps = [ttf.decode_step(tcfg, tparams, cache, tokens[:, t:t + 1], t)[0]
             for t in range(9)]
    _close(torch.cat(steps, dim=1), full.detach())

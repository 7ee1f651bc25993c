"""The recurrent archs of repro_torch — ``rwkv6-3b`` (one group of RWKV6
layers) and ``jamba-v0.1-52b`` (Mamba-1 and attention interleaved, MoE
every other layer: a pattern of two ``LayerSpec``s) — against the JAX
reference, on the CPU, in float32.

Smoke configs with the reference's weights carried across by
``convert.params_from_jax`` and inputs from a numpy seed.  Jamba runs at
``capacity_factor = n_experts``, as the reference's own
``test_decode_matches_forward`` does, so no choice is dropped.  Forwards,
losses, decode steps (one index and ragged per-row positions) and
prefills at 1e-4, caches leaf by leaf (the recurrent states included);
greedy engine tokens bit for bit the reference engine's; one faithful
DeCaPH round at sigma 0 within 1e-5 (neither arch takes the ghost path);
published rounds byte for byte the reference's files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro_torch.arms as arms
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import active_param_count as jax_active_param_count
from repro.configs.base import param_count as jax_param_count
from repro.core.dp import DPConfig as JDPConfig
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve.federation import token_silos as jax_token_silos
from repro.serve.federation import transformer_model as jax_transformer_model
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import active_param_count, param_count
from repro_torch.convert import (
    cache_to_numpy,
    params_from_jax,
    params_from_tree,
    params_to_numpy,
    params_to_tree,
)
from repro_torch.core import dp
from repro_torch.models import transformer as ttf
from repro_torch.serve import cli as tcli
from repro_torch.serve import engine as tengine
from repro_torch.serve.federation import token_silos, transformer_model
from repro_torch.serve.traffic import Request

torch.set_num_threads(1)

RWKV, JAMBA = "rwkv6-3b", "jamba-v0.1-52b"
ARCHS = [RWKV, JAMBA]
ATOL_STEP = 1e-4
ATOL_DP = 1e-5


def _pair(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if arch == JAMBA:
        jcfg, tcfg = (c.replace(capacity_factor=float(c.n_experts))
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, tcfg = _pair(arch)
        jparams = jtf.init(jcfg, jax.random.key(10 + i))
        # the constant-initialised leaves at random, so they count
        tree = jax.tree_util.tree_map(np.array, jparams)
        rng = np.random.default_rng(i)
        for layer in tree["group0"].values():
            for key, a in layer["mixer"].items():
                if key.split("|")[0] in ("bonus_u", "token_mix", "conv_b"):
                    layer["mixer"][key] = rng.uniform(
                        0.1, 0.9, a.shape).astype(a.dtype)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        out[arch] = (jcfg, tcfg, jparams,
                     params_from_jax(tree, tcfg, device="cpu"))
    return out


def _close(ours, ref, atol=ATOL_STEP):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=0)


def _caches_close(tcache, jcache, tcfg):
    ours = jax.tree_util.tree_leaves(cache_to_numpy(tcache, tcfg))
    ref = jax.tree_util.tree_leaves(jcache)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _close(a, b)


# -- configs and layout -----------------------------------------------------------


def _fields(cfg) -> dict:
    return {**vars(cfg), "stack": [(r, [dataclasses.astuple(s) for s in p])
                                   for r, p in cfg.stack]}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_are_the_references(arch):
    for ours, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert _fields(ours) == _fields(ref)
        assert param_count(ours) == jax_param_count(ref)
        assert active_param_count(ours) == jax_active_param_count(ref)
        ttf.check_supported(ours)
    full = get_config(arch)
    assert param_count(full) == {RWKV: 2_862_776_320,
                                 JAMBA: 51_569_819_648}[arch]
    # what phase 22 of chip_smoke.py serves: Jamba cut to 2 of its 4 blocks
    if arch == JAMBA:
        two = full.replace(stack=((2, full.stack[0][1]),), n_layers=16)
        assert param_count(two) == 26_053_345_280


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_converted_layout_and_dtypes(models, arch):
    """The port's own draw has the converted tree's shapes (flat ``layers``
    for RWKV6's one spec, ``group0/e0, e1`` for Jamba's two); under bf16
    the leaves the reference keeps in float32 stay float32."""
    jcfg, tcfg, _, tparams = models[arch]
    ours = ttf.init(tcfg, 0, "cpu")
    assert ("layers" in ours) == (arch == RWKV)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams)
    bf16 = ttf.init(tcfg.replace(param_dtype="bfloat16"), 0, "cpu")
    jbf16 = jtf.init(jcfg.replace(param_dtype="bfloat16"), jax.random.key(0))
    ours = [str(t.dtype)[6:] for t in jax.tree_util.tree_leaves(
        params_to_tree(bf16))]
    ref = [str(a.dtype) for a in jax.tree_util.tree_leaves(jbf16)]
    assert ours == ref and "float32" in ours


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_both_layouts_leaf_for_leaf(models, arch):
    jcfg, tcfg, jparams, tparams = models[arch]
    ours = jax.tree_util.tree_leaves(params_to_numpy(tparams, tcfg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    assert len(ours) == len(ref)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    back = params_from_tree(params_to_tree(tparams), tcfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tparams)))


@pytest.mark.parametrize("arch", ARCHS)
def test_published_round_is_the_references_file(models, tmp_path, arch):
    """The port's parameters in the reference's tree (the nested groups,
    the recurrent mixers' float32 leaves) make the file the reference
    writes, byte for byte."""
    _, _, jparams, tparams = models[arch]
    meta = {"arm": "decaph", "arch": arch}
    save_checkpoint(str(tmp_path / "port.msgpack"), params_to_tree(tparams),
                    step=1, metadata=meta)
    jsave(str(tmp_path / "ref.msgpack"), jparams, step=1, metadata=meta)
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "ref.msgpack").read_bytes()


# -- forward and loss -------------------------------------------------------------


def _batch(cfg, rng, b=2, s=11):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("impl", ["states", "quadratic"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(models, arch, impl):
    jcfg, tcfg, jparams, tparams = models[arch]
    jcfg, tcfg = (c.replace(rwkv_chunk_impl=impl, rwkv_chunk=4)
                  for c in (jcfg, tcfg))
    batch = _batch(tcfg, np.random.default_rng(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, jaux = jtf.forward(jcfg, jparams, jb)
    logits, aux = ttf.forward(tcfg, tparams, tb)
    _close(logits.detach(), jlogits)
    _close(float(aux), float(jaux))
    assert (float(aux) > 0) == (arch == JAMBA)
    _close(float(ttf.loss_fn(tcfg, tparams, tb)),
           float(jtf.loss_fn(jcfg, jparams, jb)))


# -- decode steps and prefill -----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(models, arch):
    """A 6-token prefill of 3 rows, ``decode_step_positions`` at ragged
    per-row positions (rows' recurrent states advance, the attention layer
    writes and attends per row) and ``decode_step`` at one index: logits
    and every cache leaf, the ``ssm`` states included."""
    jcfg, tcfg, jparams, tparams = models[arch]
    jcfg, tcfg = (c.replace(use_decode_kernel=True) for c in (jcfg, tcfg))
    rng = np.random.default_rng(2)
    b, max_len = 3, 16
    prompt = rng.integers(0, tcfg.vocab_size, (b, 6)).astype(np.int32)
    jlogits, jcache = jtf.prefill(jcfg, jparams,
                                  jtf.init_cache(jcfg, b, max_len),
                                  jnp.asarray(prompt))
    logits, tcache = ttf.prefill(tcfg, tparams,
                                 ttf.init_cache(tcfg, b, max_len, "cpu"),
                                 torch.from_numpy(prompt))
    _close(logits, jlogits)
    _caches_close(tcache, jcache, tcfg)
    tokens = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    positions = np.array([6, 2, 11], np.int32)
    jlogits, jcache = jtf.decode_step_positions(
        jcfg, jparams, jcache, jnp.asarray(tokens), jnp.asarray(positions))
    logits, tcache = ttf.decode_step_positions(
        tcfg, tparams, tcache, torch.from_numpy(tokens),
        torch.from_numpy(positions))
    _close(logits, jlogits)
    _caches_close(tcache, jcache, tcfg)
    jlogits, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(tokens), 12)
    logits, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(tokens), 12)
    _close(logits, jlogits)
    _caches_close(tcache, jcache, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """Teacher-forced decode steps from an empty cache give the forward's
    logits at every position (the reference's own check of its stack)."""
    _, tcfg, _, tparams = models[arch]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32))
    full, _ = ttf.forward(tcfg, tparams, {"tokens": tokens})
    cache = ttf.init_cache(tcfg, 2, 9, "cpu")
    steps = [ttf.decode_step(tcfg, tparams, cache, tokens[:, t:t + 1], t)[0]
             for t in range(9)]
    _close(torch.cat(steps, dim=1), full.detach())


def test_cache_layout_is_the_references():
    """The cache's tree in the reference's nesting (RWKV6's flat one
    through ``cache_tree``), shapes and dtypes: K and V in the compute
    dtype, Mamba's conv history in it too, the recurrent states float32."""
    for arch in ARCHS:
        jcfg, tcfg = _pair(arch)
        jcfg, tcfg = (c.replace(compute_dtype="bfloat16")
                      for c in (jcfg, tcfg))
        ours = ttf.cache_tree(tcfg, ttf.init_cache(tcfg, 3, 8, "cpu"))
        ref = jtf.init_cache(jcfg, 3, 8)
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, ours)) == \
            jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda t: 0, ref))
        assert [(tuple(t.shape), str(t.dtype)[6:])
                for t in jax.tree_util.tree_leaves(ours)] == \
            [(a.shape, str(a.dtype)) for a in jax.tree_util.tree_leaves(ref)]


# -- serving ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_generate_tokens_are_the_references(models, arch):
    jcfg, tcfg, jparams, tparams = models[arch]
    prompts = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (3, 5)).astype(np.int32)
    kw = dict(slots=3, max_len=16, temperature=0.0)
    ours = tengine.batch_generate(tengine.ServeEngine(
        tengine.ServeConfig(arch=arch, device="cpu", **kw), model_cfg=tcfg,
        params=tparams), prompts, 7)
    ref = jengine.batch_generate(jengine.ServeEngine(
        jengine.ServeConfig(arch=arch, **kw), model_cfg=jcfg,
        params=jparams), prompts, 7)
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_resets_a_freed_slots_state(models, arch):
    """A request admitted into a slot another request has left generates
    what it generates on a fresh engine: the insert overwrites every
    cache leaf of the row, the recurrent states too."""
    _, tcfg, _, tparams = models[arch]
    rng = np.random.default_rng(5)
    first, second = (rng.integers(0, tcfg.vocab_size, 4).astype(np.int32)
                     for _ in range(2))

    def engine():
        return tengine.ServeEngine(tengine.ServeConfig(
            arch=arch, slots=1, max_len=12, temperature=0.0, device="cpu"),
            model_cfg=tcfg, params=tparams)

    used = engine()
    tengine.batch_generate(used, first[None], 5)
    assert used.free_slots() == 1
    again = tengine.batch_generate(used, second[None], 5)
    fresh = tengine.batch_generate(engine(), second[None], 5)
    np.testing.assert_array_equal(again, fresh)


def test_serve_cli_takes_both_archs(capsys):
    parser = tcli.build_parser()
    for arch in ARCHS:
        assert parser.parse_args(["--arch", arch]).arch == arch
    assert tcli.main(["--arch", JAMBA, "--device", "cpu", "--requests", "3",
                      "--rate", "50", "--slots", "2"]) == 0
    assert "jamba" in capsys.readouterr().out


def test_one_decode_step_is_one_call_and_admission_two(models):
    """The engine's dispatch contract holds for a nested cache."""
    _, tcfg, _, tparams = models[JAMBA]
    engine = tengine.ServeEngine(tengine.ServeConfig(
        arch=JAMBA, slots=2, max_len=12, temperature=0.0, device="cpu"),
        model_cfg=tcfg, params=tparams)
    req = Request(rid=0, arrival=0.0, prompt=np.arange(1, 5, dtype=np.int32),
                  max_new_tokens=3)
    engine.admit(req)
    engine.step()
    assert (engine.admit_dispatches, engine.decode_dispatches) == (2, 1)


# -- DP ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_faithful_decaph_round_matches_reference(models, arch):
    """One DeCaPH round at sigma 0 on the faithful per-example path
    (``torch.func.vmap`` of ``grad`` through the scans; untied heads, so
    only the mixers keep them off the ghost path)."""
    jcfg, tcfg, jparams, _ = models[arch]
    jcfg, tcfg = (c.replace(tie_embeddings=False) for c in (jcfg, tcfg))
    jmodel = jax_transformer_model(jcfg)
    tmodel = transformer_model(tcfg, device="cpu")
    assert jmodel.ghost is None and tmodel.ghost is None
    p0 = jax.tree_util.tree_map(np.asarray, jparams)
    jmodel = dataclasses.replace(jmodel, init_fn=lambda key: jparams)
    tmodel = dataclasses.replace(tmodel, init_fn=lambda seed: params_from_jax(
        p0, tcfg, device="cpu"))
    kw = dict(rounds=1, batch_size=6, lr=0.05, use_secagg=False)
    ref = jarms.run("decaph", jmodel, jax_token_silos(
        jcfg, hospitals=2, n_per=6, seq_len=6, seed=0), jarms.ArmConfig(
        dp=JDPConfig(clip_norm=1.0, noise_multiplier=0.0, microbatch_size=3),
        **kw))
    ours = arms.run("decaph", tmodel, token_silos(
        tcfg, hospitals=2, n_per=6, seq_len=6, seed=0), arms.ArmConfig(
        dp=dp.DPConfig(clip_norm=1.0, noise_multiplier=0.0,
                       microbatch_size=3), **kw))
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

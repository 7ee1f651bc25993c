"""The model zoo's GQA decoders in repro_torch against the JAX reference, on
the CPU, in float32.

The five configs the port adds (``olmo-1b``, ``gemma-7b``, ``qwen2-vl-2b``,
``qwen3-moe-30b-a3b``, ``nemotron-4-340b``) at their smoke sizes, each with
the reference's parameters carried across by ``convert.params_from_jax``
and inputs drawn with numpy from a seed.  Tolerances, as in
``test_torch_model.py``: layers at 1e-6, forwards and losses at 1e-5
(the auxiliary loss included), whole decode steps and prefills at 1e-4
(float32 sums ordered differently over 2 layers and a 512-way head).
Qwen3-30B-A3B runs at its own capacity factor (1.25) and at 0.25, where
tokens are dropped; the MoE dispatch and combine are also held to the
reference's on hand-made routings, the buffer bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import active_param_count as jax_active_param_count
from repro.configs.base import param_count as jax_param_count
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.configs.base import active_param_count, param_count
from repro_torch.convert import (
    cache_to_numpy,
    params_from_jax,
    params_from_tree,
    params_to_numpy,
    params_to_tree,
)
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ZOO = ["olmo-1b", "gemma-7b", "qwen2-vl-2b", "qwen3-moe-30b-a3b",
       "nemotron-4-340b"]
MOE = "qwen3-moe-30b-a3b"
# (arch, capacity factor): every arch at its own, and Qwen3 at 0.25, where
# a step's or a forward's tokens lose choices to capacity
CASES = [(a, None) for a in ZOO] + [(MOE, 0.25)]
ATOL_LAYER = 1e-6
ATOL_FWD = 1e-5
ATOL_STEP = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pair(arch, capacity_factor=None):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if capacity_factor is not None:
        jcfg = jcfg.replace(capacity_factor=capacity_factor)
        tcfg = tcfg.replace(capacity_factor=capacity_factor)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def zoo():
    """Per arch: the reference's smoke parameters and the port's copy."""
    out = {}
    for i, arch in enumerate(ZOO):
        jcfg, tcfg = _pair(arch)
        jparams = jtf.init(jcfg, jax.random.key(i))
        out[arch] = (jparams, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    return out


def _case(zoo, arch, capacity_factor):
    return (*_pair(arch, capacity_factor), *zoo[arch])


# -- configs -------------------------------------------------------------------


def _fields(cfg) -> dict:
    # every field, the stack's LayerSpecs (one class per package) as tuples
    return {**vars(cfg), "stack": [(r, [dataclasses.astuple(s) for s in p])
                                   for r, p in cfg.stack]}


@pytest.mark.parametrize("arch", ZOO)
def test_configs_and_param_counts_are_the_references(arch):
    for ours, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert _fields(ours) == _fields(ref)
        assert param_count(ours) == jax_param_count(ref)
        assert active_param_count(ours) == jax_active_param_count(ref)
        ttf.check_supported(ours)


def test_registry_holds_the_zoo_and_refuses_the_rest():
    assert set(ZOO) < set(ARCHITECTURES)
    # the recurrent mixers' archs are ported: their configs are the
    # reference's and the engine takes them
    for arch in ("rwkv6-3b", "jamba-v0.1-52b"):
        assert arch in ARCHITECTURES
        assert _fields(get_config(arch)) == _fields(jax_config(arch))
        ttf.check_supported(get_config(arch))
        engine = tengine.ServeEngine(tengine.ServeConfig(arch=arch,
                                                         device="cpu"))
        assert engine.model_cfg.name == arch
    # and so are the last two: their configs are the reference's and
    # check_supported takes them; the engine serves DeepSeek-V3 and
    # refuses Whisper's encoder-decoder, with the reference's words
    for arch in ("deepseek-v3-671b", "whisper-small"):
        assert arch in ARCHITECTURES
        assert _fields(get_config(arch)) == _fields(jax_config(arch))
        ttf.check_supported(get_config(arch))
    assert set(ARCHITECTURES) == set(jax_list_archs())
    engine = tengine.ServeEngine(tengine.ServeConfig(arch="deepseek-v3-671b",
                                                     device="cpu"))
    assert engine.model_cfg.name == "deepseek-v3-671b"
    with pytest.raises(ValueError, match="encoder-decoder") as ours:
        tengine.ServeEngine(tengine.ServeConfig(arch="whisper-small",
                                                device="cpu"))
    with pytest.raises(ValueError, match="encoder-decoder") as ref:
        jengine.ServeEngine(jengine.ServeConfig(arch="whisper-small"))
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("llama-9000")


@pytest.mark.parametrize("arch", ZOO)
def test_init_has_the_converted_layout(zoo, arch):
    tcfg = get_smoke_config(arch)
    ours = ttf.init(tcfg, 0, "cpu")
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), ours)
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), t.dtype), zoo[arch][1])
    # no norm parameters under ln_nonparam; the router float32 under bf16
    assert ("final_norm" in ours) == (tcfg.norm == "rmsnorm")
    bf16 = ttf.init(tcfg.replace(param_dtype="bfloat16"), 0, "cpu")
    assert {n: t.dtype for n, t in bf16["layers"].items()} == {
        n: torch.float32 if n == "w_router" else torch.bfloat16
        for n in bf16["layers"]}


# -- layers --------------------------------------------------------------------


def test_layernorm_nonparam_matches_reference():
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.standard_normal((3, 5, 128))).astype(np.float32)
    ref = jl.layernorm_nonparam(jnp.asarray(x))
    out = tl.apply_norm("ln_nonparam", None, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_LAYER,
                               rtol=0)


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24), (2, 3, 2)])
def test_apply_mrope_matches_reference(sections):
    """Distinct (t, h, w) ids, so a wrong section split shows; (2, 3, 2)
    sums below D/2 and the last pairs take component 2, as the reference's
    ``total_repeat_length`` fills them."""
    d = 2 * max(16, sum(sections))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, d)).astype(np.float32)
    pos3 = rng.integers(0, 64, (2, 5, 3)).astype(np.int32)
    ref = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    out = tl.apply_mrope(_t(x), torch.from_numpy(pos3), 1e6, sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_LAYER,
                               rtol=0)


# -- MoE dispatch and combine --------------------------------------------------


# (top_ids [T, K], capacity): ties in expert ids (many tokens on expert 0, in
# both choice columns), an expert over capacity, every pair kept
ROUTINGS = [
    ([[0, 1], [0, 2], [1, 0], [0, 3], [2, 0]], 2),
    ([[3, 2], [3, 0], [3, 1], [3, 2], [1, 3], [0, 3]], 3),
    ([[0, 1], [2, 3], [1, 2], [3, 0]], 4),
]


@pytest.mark.parametrize("top_ids,capacity", ROUTINGS)
def test_dispatch_and_combine_match_reference(top_ids, capacity):
    rng = np.random.default_rng(3)
    ids = np.asarray(top_ids, np.int32)
    t, k = ids.shape
    e, d = 4, 8
    x = rng.standard_normal((t, d)).astype(np.float32)
    probs = rng.uniform(0.1, 1.0, (t, k)).astype(np.float32)
    jbuf, jmeta = jmoe._dispatch_group(jnp.asarray(x), jnp.asarray(ids),
                                       jnp.asarray(probs), e, capacity)
    buf, meta = tmoe._dispatch_group(_t(x)[None],
                                     torch.from_numpy(ids).long()[None], e,
                                     capacity)
    np.testing.assert_array_equal(buf[0].numpy(), np.asarray(jbuf))
    h = rng.standard_normal((e, capacity, d)).astype(np.float32)
    ref = jmoe._combine_group(jnp.asarray(h), jmeta, jnp.asarray(probs), t, k)
    out = tmoe._combine_group(_t(h)[None], meta, _t(probs)[None], t, k)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref),
                               atol=ATOL_LAYER, rtol=0)
    kept = int(meta[2].sum())
    assert kept == min(t * k, int(np.minimum(np.bincount(
        ids.reshape(-1), minlength=e), capacity).sum()))


@pytest.mark.parametrize("capacity_factor,groups", [(None, 1), (0.25, 1),
                                                     (None, 3)])
def test_moe_apply_matches_reference(zoo, capacity_factor, groups):
    jcfg, tcfg = _pair(MOE, capacity_factor)
    jcfg, tcfg = (c.replace(moe_groups=groups) for c in (jcfg, tcfg))
    jparams, tparams = zoo[MOE]
    jp = jparams["group0"]["e0"]["ffn"]
    jp = jax.tree_util.tree_map(lambda a: a[1], jp)          # layer 1
    tp = {n: t[1] for n, t in tparams["layers"].items()}
    x = np.random.default_rng(4).standard_normal(
        (3, 4, tcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = tmoe.moe_apply(tp, _t(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL_FWD,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# -- forward and loss ----------------------------------------------------------


def _batch(cfg, rng, b=2, s=9, vision=0):
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if vision:
        batch["vision_embeds"] = rng.standard_normal(
            (b, vision, cfg.d_model)).astype(np.float32)
        # distinct (t, h, w) ids: a 2 x (vision / 2) patch grid at t = 0,
        # then the text at t = h = w = 1, 2, ...
        grid = [(0, i // (vision // 2), i % (vision // 2))
                for i in range(vision)]
        text = [(j + 1,) * 3 for j in range(s)]
        batch["mrope_positions"] = np.broadcast_to(
            np.asarray(grid + text, np.int32), (b, vision + s, 3)).copy()
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,capacity_factor", CASES)
def test_forward_and_loss_match_reference(zoo, arch, capacity_factor):
    jcfg, tcfg, jparams, tparams = _case(zoo, arch, capacity_factor)
    batch = _batch(tcfg, np.random.default_rng(5))
    jlogits, jaux = jtf.forward(jcfg, jparams, _jax(batch))
    logits, aux = ttf.forward(tcfg, tparams, _torch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_FWD, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL_FWD)
    assert (float(aux) > 0) == (arch == MOE)
    np.testing.assert_allclose(
        float(ttf.loss_fn(tcfg, tparams, _torch(batch))),
        float(jtf.loss_fn(jcfg, jparams, _jax(batch))), atol=ATOL_FWD)


@pytest.mark.parametrize("mrope", [True, False])
def test_vlm_stub_matches_reference(zoo, mrope):
    """Vision embeddings prefix the text, M-RoPE at distinct (t, h, w) ids
    (or broadcast from the positions), the loss over the text only."""
    jcfg, tcfg, jparams, tparams = _case(zoo, "qwen2-vl-2b", None)
    batch = _batch(tcfg, np.random.default_rng(6), s=7, vision=6)
    if not mrope:
        del batch["mrope_positions"]
    jlogits, _ = jtf.forward(jcfg, jparams, _jax(batch))
    logits, _ = ttf.forward(tcfg, tparams, _torch(batch))
    assert logits.shape == (2, 13, tcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_FWD, rtol=0)
    loss = float(ttf.loss_fn(tcfg, tparams, _torch(batch)))
    np.testing.assert_allclose(loss, float(jtf.loss_fn(jcfg, jparams,
                                                       _jax(batch))),
                               atol=ATOL_FWD)
    text = ttf._ce(logits[:, 6:], torch.from_numpy(batch["labels"]))
    assert loss == float(text)


# -- decode step and prefill ---------------------------------------------------


def _assert_caches_close(jcache, tcache, tcfg):
    ours = cache_to_numpy(tcache, tcfg)["group0"]["e0"]["attn"]
    ref = jcache["group0"]["e0"]["attn"]
    for name in ("k", "v"):
        np.testing.assert_allclose(ours[name], np.asarray(ref[name]),
                                   atol=ATOL_STEP, rtol=0)


def _random_cache(cfg, rng, b, max_len):
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return ({"group0": {"e0": {"attn": {"k": jnp.asarray(k),
                                        "v": jnp.asarray(v)}}}},
            {"k": _t(k), "v": _t(v)})


@pytest.mark.parametrize("arch,capacity_factor", CASES)
def test_decode_steps_and_prefill_match_reference(zoo, arch,
                                                  capacity_factor):
    """``decode_step_positions`` (each row at its own position; the MoE
    dispatches each row alone), ``decode_step`` (every row at one index;
    the MoE dispatches the rows as one group) and ``prefill``."""
    jcfg, tcfg, jparams, tparams = _case(zoo, arch, capacity_factor)
    jcfg, tcfg = (c.replace(use_decode_kernel=True) for c in (jcfg, tcfg))
    rng = np.random.default_rng(7)
    b, max_len = 3, 16
    tokens = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    positions = np.array([5, 0, 15], np.int32)
    jcache, tcache = _random_cache(tcfg, rng, b, max_len)
    jlogits, jcache = jtf.decode_step_positions(
        jcfg, jparams, jcache, jnp.asarray(tokens), jnp.asarray(positions))
    logits, tcache = ttf.decode_step_positions(
        tcfg, tparams, tcache, torch.from_numpy(tokens),
        torch.from_numpy(positions))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_STEP, rtol=0)
    _assert_caches_close(jcache, tcache, tcfg)

    jlogits, jcache = jtf.decode_step(jcfg, jparams, jcache,
                                      jnp.asarray(tokens), 9)
    logits, tcache = ttf.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(tokens), 9)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_STEP, rtol=0)
    _assert_caches_close(jcache, tcache, tcfg)

    prompt = rng.integers(0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    jlogits, jcache = jtf.prefill(jcfg, jparams,
                                  jtf.init_cache(jcfg, 2, max_len),
                                  jnp.asarray(prompt))
    logits, tcache = ttf.prefill(tcfg, tparams,
                                 ttf.init_cache(tcfg, 2, max_len, "cpu"),
                                 torch.from_numpy(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL_STEP, rtol=0)
    _assert_caches_close(jcache, tcache, tcfg)
    if capacity_factor == 0.25:   # the drops are real: without them the
        # prefill's last logits move
        wide = ttf.prefill(tcfg.replace(capacity_factor=100.0), tparams,
                           ttf.init_cache(tcfg, 2, max_len, "cpu"),
                           torch.from_numpy(prompt))[0]
        assert float((wide - logits).abs().max()) > 1e-3


@pytest.mark.parametrize("arch,capacity_factor",
                         [("gemma-7b", None), (MOE, None), (MOE, 0.25)])
def test_batch_generate_tokens_are_the_references(zoo, arch,
                                                  capacity_factor):
    jcfg, tcfg, jparams, tparams = _case(zoo, arch, capacity_factor)
    prompts = np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (3, 5)).astype(np.int32)
    kw = dict(slots=3, max_len=16, temperature=0.0)
    ours = tengine.batch_generate(tengine.ServeEngine(
        tengine.ServeConfig(arch=arch, device="cpu", **kw), model_cfg=tcfg,
        params=tparams), prompts, 6)
    ref = jengine.batch_generate(jengine.ServeEngine(
        jengine.ServeConfig(arch=arch, **kw), model_cfg=jcfg,
        params=jparams), prompts, 6)
    np.testing.assert_array_equal(ours, np.asarray(ref))


def test_engine_serves_every_new_arch_at_smoke_scale():
    prompts = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    for arch in ZOO:
        engine = tengine.ServeEngine(tengine.ServeConfig(
            arch=arch, slots=2, max_len=12, temperature=0.0, device="cpu"))
        out = tengine.batch_generate(engine, prompts, 3)
        assert out.shape == (2, 3)
        assert engine.model_cfg.use_decode_kernel


# -- checkpoints -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo-1b", MOE])
def test_published_round_is_the_references_file(zoo, tmp_path, arch):
    """The port's parameters in the reference's tree (empty norm dicts under
    ``ln_nonparam``, the MoE leaves under ``ffn``) make the file the
    reference writes, byte for byte, and load back leaf for leaf."""
    jparams, tparams = zoo[arch]
    meta = {"arm": "decaph", "arch": arch}
    tree = params_to_tree(tparams)
    save_checkpoint(str(tmp_path / "port.msgpack"), tree, step=3,
                    metadata=meta)
    jsave(str(tmp_path / "ref.msgpack"), jparams, step=3, metadata=meta)
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "ref.msgpack").read_bytes()
    back = params_from_tree(tree, get_smoke_config(arch), "cpu")
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tparams)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tparams)))
    ours = jax.tree_util.tree_leaves(params_to_numpy(tparams,
                                                     get_smoke_config(arch)))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    assert len(ours) == len(ref)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))

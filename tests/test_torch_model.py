"""repro_torch model code against the JAX reference, on the CPU, in float32.

Inputs are made with numpy from a seed and fed to both frameworks; the
reference's parameters (``repro.models.transformer.init`` on the smoke
config) cross to the port through ``repro_torch.convert.params_from_jax``.
The layers are held at atol 1e-6.  Whole decode steps and prefills are
held at 1e-4: the two frameworks order float32 sums differently, and over
2 layers and a 512-way tied head those differences grow past 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import param_count as jax_param_count
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import LayerSpec, param_count
from repro_torch.convert import cache_to_numpy, params_from_jax
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

ATOL_LAYER = 1e-6
ATOL_STEP = 1e-4   # fp32 sums ordered differently over 2 layers + 512-way head


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("smollm-360m")
    params = jtf.init(jcfg, jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = get_smoke_config("smollm-360m")
    return jcfg, params, tcfg, params_from_jax(np_params, tcfg)


def _cfgs(models, decode_kernel):
    jcfg, jparams, tcfg, tparams = models
    return (jcfg.replace(use_decode_kernel=decode_kernel), jparams,
            tcfg.replace(use_decode_kernel=decode_kernel), tparams)


def _assert_caches_close(jcache, tcache):
    ours = cache_to_numpy(tcache)["group0"]["e0"]["attn"]
    ref = jcache["group0"]["e0"]["attn"]
    for name in ("k", "v"):
        np.testing.assert_allclose(ours[name], np.asarray(ref[name]),
                                   atol=ATOL_STEP, rtol=0)


# -- layers -------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    ref = jl.rmsnorm({jl.pname("scale", "embed"): jnp.asarray(scale)},
                     jnp.asarray(x))
    out = tl.rmsnorm(_t(x), _t(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_LAYER,
                               rtol=0)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 512, (2, 5)).astype(np.int32)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tl.apply_rope(_t(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_LAYER,
                               rtol=0)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_ffn_apply_matches_reference(kind):
    rng = np.random.default_rng(3)
    d, f = 32, 64
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    ws = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    if kind in ("relu2", "gelu"):
        del ws["w_gate"]
    ours = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in ws.items()}
    axes = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}
    ref = jl.ffn_apply({jl.pname(n, *axes[n]): jnp.asarray(a)
                        for n, a in ours.items()}, jnp.asarray(x), kind)
    out = tl.ffn_apply({n: _t(a) for n, a in ours.items()}, _t(x), kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_LAYER,
                               rtol=0)


def test_trunc_normal_truncates_in_unit_normal_units():
    # jax.random.truncated_normal(-2, 2) * stddev: |x| <= 2*stddev and the
    # variance is NOT renormalised (std of the truncated unit normal: 0.8796)
    g = torch.Generator().manual_seed(0)
    x = tl.trunc_normal((200_000,), torch.float32, 0.5, g)
    assert float(x.abs().max()) <= 1.0
    assert abs(float(x.std()) - 0.5 * 0.8796) < 0.005


# -- configs and parameters ---------------------------------------------------


def test_full_config_param_count():
    cfg = get_config("smollm-360m")
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (960, 32, 15, 5, 64,
                                                        2560, 49152)
    assert cfg.tie_embeddings and cfg.pdtype == torch.bfloat16
    assert param_count(cfg) == 361_758_720
    from repro.configs import get_config as jax_config
    assert param_count(cfg) == jax_param_count(jax_config("smollm-360m"))


def test_unported_arch_and_mixer_raise():
    with pytest.raises(ValueError, match="ROADMAP.md"):
        get_config("gemma-7b")
    cfg = get_smoke_config("smollm-360m")
    moe = cfg.replace(stack=((2, (LayerSpec("attn", "moe"),)),))
    with pytest.raises(NotImplementedError):
        ttf.init(moe, 0, "cpu")


def test_port_init_has_the_converted_layout(models):
    _, _, tcfg, tparams = models
    ours = ttf.init(tcfg, 0, "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), ours)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams)
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(ours))


# -- decode step and prefill ----------------------------------------------------


@pytest.mark.parametrize("decode_kernel", [True, False])
def test_decode_step_positions_matches_reference(models, decode_kernel):
    jcfg, jparams, tcfg, tparams = _cfgs(models, decode_kernel)
    rng = np.random.default_rng(4)
    b, max_len = 3, 16
    shape = (jcfg.n_layers, b, max_len, jcfg.n_kv_heads, jcfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    positions = np.array([5, 0, 15], np.int32)   # each row at its own place
    jcache = {"group0": {"e0": {"attn": {"k": jnp.asarray(k),
                                         "v": jnp.asarray(v)}}}}
    jlogits, jcache = jtf.decode_step_positions(
        jcfg, jparams, jcache, jnp.asarray(tokens), jnp.asarray(positions))
    tlogits, tcache = ttf.decode_step_positions(
        tcfg, tparams, {"k": _t(k), "v": _t(v)}, torch.from_numpy(tokens),
        torch.from_numpy(positions))
    assert tlogits.shape == (b, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL_STEP, rtol=0)
    _assert_caches_close(jcache, tcache)


def test_prefill_matches_reference(models):
    jcfg, jparams, tcfg, tparams = _cfgs(models, True)
    rng = np.random.default_rng(5)
    b, s, max_len = 2, 7, 16
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    jlogits, jcache = jtf.prefill(jcfg, jparams,
                                  jtf.init_cache(jcfg, b, max_len),
                                  jnp.asarray(tokens))
    tlogits, tcache = ttf.prefill(tcfg, tparams,
                                  ttf.init_cache(tcfg, b, max_len, "cpu"),
                                  torch.from_numpy(tokens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL_STEP, rtol=0)
    _assert_caches_close(jcache, tcache)

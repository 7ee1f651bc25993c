"""The recurrent mixers of repro_torch (``models/ssm.py``) against the JAX
reference's ``repro.models.ssm``, on the CPU, in float32.

Mamba-1 (``jamba-v0.1-52b``'s smoke layer) and RWKV6 (``rwkv6-3b``'s) with
the reference's weights carried across by ``convert.params_from_jax``; the
leaves the reference initialises to constants (RWKV6's ``bonus_u`` and
``token_mix``, Mamba's ``conv_b``) are drawn at random first, so a wrong
bonus, mix or bias shows.  Inputs come from a numpy seed.  Full sequences
at S below, at and past the scans' chunks (Mamba 256, RWKV6 32) and not a
multiple of them, both RWKV6 chunk implementations; one decode step from
random states.  Tolerance 1e-5: the port's Hillis-Steele scan and the
reference's ``associative_scan`` combine the same float32 terms in other
orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

ATOL = 1e-5
RWKV, JAMBA = "rwkv6-3b", "jamba-v0.1-52b"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _randomised(arch, seed):
    """The reference's smoke parameters with its constant-initialised mixer
    leaves redrawn (numpy leaves), and the port's copy."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    tree = jax.tree_util.tree_map(np.array, jtf.init(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    mixer = tree["group0"]["e0"]["mixer"]
    for key, a in mixer.items():
        if key.startswith("bonus_u"):
            mixer[key] = (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        elif key.startswith("token_mix"):
            mixer[key] = rng.uniform(0, 1, a.shape).astype(a.dtype)
        elif key.startswith("conv_b"):
            mixer[key] = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg, tree, tparams = _randomised(RWKV, 0)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]),
                                tree["group0"]["e0"]["mixer"])
    tp = {n: t[1] for n, t in tparams["layers"].items()}
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg, tree, tparams = _randomised(JAMBA, 1)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                tree["group0"]["e0"]["mixer"])
    tp = {n: t[0] for n, t in tparams["group0"]["e0"].items()}
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


# -- the in-chunk scan ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 8, 33])
def test_diag_scan_is_the_recurrence(n):
    """Inclusive products of a and h_t = a_t h_{t-1} + b_t from h = 0, with
    a broadcasting over b's last axis as RWKV6's decay does."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 3, 1)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    a_cum, h = tssm._diag_scan(_t(a), _t(b))
    prod, state = np.ones((2, 3, 1), np.float32), np.zeros((2, 3, 4), np.float32)
    for t in range(n):
        prod, state = prod * a[:, t], a[:, t] * state + b[:, t]
        np.testing.assert_allclose(a_cum[:, t].numpy(), prod, rtol=1e-6)
        np.testing.assert_allclose(h[:, t].numpy(), state, rtol=1e-5,
                                   atol=1e-6)


# -- Mamba-1 ----------------------------------------------------------------------


@pytest.mark.parametrize("s", [7, 256, 300])
def test_mamba_apply_matches_reference(mamba, s):
    """S below the 256-step chunk, at it and past it (a padded second
    chunk, dt = 0 on the pad)."""
    jcfg, tcfg, jp, tp = mamba
    x = _x(tcfg, 2, s, s)
    _close(tssm.mamba_apply(tp, _t(x), tcfg),
           jssm.mamba_apply(jp, jnp.asarray(x), jcfg))


def test_mamba_decode_matches_reference(mamba):
    jcfg, tcfg, jp, tp = mamba
    rng = np.random.default_rng(2)
    di = tcfg.mamba_expand * tcfg.d_model
    conv = rng.standard_normal((3, tcfg.mamba_d_conv - 1, di)).astype(
        np.float32)
    ssm = rng.standard_normal((3, di, tcfg.mamba_d_state)).astype(np.float32)
    x = _x(tcfg, 3, 1, 3)
    jy, jcache = jssm.mamba_decode(jp, jnp.asarray(x), {
        "conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}, jcfg)
    cache = {"conv": _t(conv), "ssm": _t(ssm)}
    y, out = tssm.mamba_decode(tp, _t(x), cache, tcfg)
    _close(y, jy)
    assert out is cache        # the state is written in place
    for name in ("conv", "ssm"):
        _close(cache[name], jcache[name])


def test_mamba_init_has_the_reference_leaves(mamba):
    """Shapes, dtypes (``a_log`` and ``d_skip`` float32 under bf16) and the
    constant leaves of the port's own draw."""
    jcfg, tcfg, jp, _ = mamba
    cfg = tcfg.replace(param_dtype="bfloat16")
    ours = tssm.mamba_init(cfg, cfg.pdtype, torch.Generator().manual_seed(0))
    ref = jssm.mamba_init(jax.random.key(0), jcfg.replace(
        param_dtype="bfloat16"), jnp.bfloat16)
    by_name = {k.split("|")[0]: v for k, v in ref.items()}
    assert set(ours) == set(by_name)
    for name, t in ours.items():
        assert tuple(t.shape) == by_name[name].shape
        assert str(t.dtype)[6:] == str(by_name[name].dtype)
    np.testing.assert_array_equal(ours["a_log"].numpy(),
                                  np.asarray(by_name["a_log"]))
    assert bool((ours["d_skip"] == 1).all()) and bool((ours["conv_b"] == 0)
                                                      .all())
    # dt = softplus(dt_bias) lies in the reference's [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(ours["dt_bias"].float())
    assert float(dt.min()) >= 9e-4 and float(dt.max()) <= 0.101


# -- RWKV6 ------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["states", "quadratic"])
@pytest.mark.parametrize("s", [7, 32, 45, 64])
def test_rwkv6_apply_matches_reference(rwkv, impl, s):
    """Both chunk implementations at S below the 32-position chunk, at it,
    past it (a padded chunk, decay 1 on the pad) and at two chunks."""
    jcfg, tcfg, jp, tp = rwkv
    jcfg, tcfg = (c.replace(rwkv_chunk_impl=impl) for c in (jcfg, tcfg))
    x = _x(tcfg, 2, s, 10 + s)
    _close(tssm.rwkv6_apply(tp, _t(x), tcfg),
           jssm.rwkv6_apply(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("chunk", [8, 16])
def test_rwkv6_wkv_scans_match_reference_states(rwkv, chunk):
    """The WKV scans' outputs and final states at chunks other than the
    default, on decays drawn down to 1e-6 (the exclusive state comes from a
    shift, never from dividing by a decay)."""
    _, tcfg, _, _ = rwkv
    rng = np.random.default_rng(chunk)
    nh, hs = tcfg.d_model // tcfg.rwkv_head_size, tcfg.rwkv_head_size
    r, k, v = (rng.standard_normal((2, 21, nh, hs)).astype(np.float32)
               for _ in range(3))
    w = np.exp(rng.uniform(np.log(1e-6), 0, (2, 21, nh, hs))).astype(
        np.float32)
    u = rng.standard_normal((nh, hs)).astype(np.float32)
    jy, js = jssm._rwkv_wkv_scan(*map(jnp.asarray, (r, k, v, w, u)),
                                 chunk=chunk)
    y, state = tssm._rwkv_wkv_scan(*map(_t, (r, k, v, w, u)), chunk=chunk)
    _close(y, jy)
    _close(state, js)


def test_rwkv6_decode_matches_reference(rwkv):
    jcfg, tcfg, jp, tp = rwkv
    rng = np.random.default_rng(4)
    nh, hs = tcfg.d_model // tcfg.rwkv_head_size, tcfg.rwkv_head_size
    x_prev = _x(tcfg, 3, 1, 5)
    wkv = rng.standard_normal((3, nh, hs, hs)).astype(np.float32)
    x = _x(tcfg, 3, 1, 6)
    jy, jcache = jssm.rwkv6_decode(jp, jnp.asarray(x), {
        "x_prev": jnp.asarray(x_prev), "wkv": jnp.asarray(wkv)}, jcfg)
    cache = {"x_prev": _t(x_prev), "wkv": _t(wkv)}
    y, out = tssm.rwkv6_decode(tp, _t(x), cache, tcfg)
    _close(y, jy)
    assert out is cache
    for name in ("x_prev", "wkv"):
        _close(cache[name], jcache[name])


def test_rwkv6_decode_steps_are_the_scan(rwkv):
    """Decoding a sequence token by token from a zero state gives the full
    sequence's mixer output (the scan) at every position."""
    _, tcfg, _, tp = rwkv
    x = _t(_x(tcfg, 2, 40, 7))
    full = tssm.rwkv6_apply(tp, x, tcfg)
    cache = tssm.rwkv6_init_cache(tcfg, 2, torch.float32, "cpu")
    steps = [tssm.rwkv6_decode(tp, x[:, t:t + 1], cache, tcfg)[0]
             for t in range(x.shape[1])]
    _close(torch.cat(steps, dim=1), full.detach().numpy())


def test_scans_run_under_vmap_of_grad(rwkv, mamba):
    """The faithful DP path vmaps per-example gradients through both
    mixers: equal to a loop over the examples."""
    for cfg, p, fn in ((rwkv[1], rwkv[3], tssm.rwkv6_apply),
                       (mamba[1], mamba[3], tssm.mamba_apply)):
        x = _t(_x(cfg, 3, 9, 8))

        def loss(params, xi):
            return fn(params, xi[None], cfg).square().mean()

        grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
            p, x)
        for i in range(3):
            one = torch.func.grad(loss)(p, x[i])
            for name in p:
                np.testing.assert_allclose(grads[name][i].numpy(),
                                           one[name].numpy(), atol=1e-6,
                                           rtol=1e-5)


def test_ghost_path_excludes_both_mixers():
    from repro.core import ghost as jghost
    from repro_torch.core import ghost as tghost
    for arch in (RWKV, JAMBA):
        assert not tghost._supported(get_smoke_config(arch))
        assert not jghost._supported(jax_smoke_config(arch))
        ttf.check_supported(get_smoke_config(arch))

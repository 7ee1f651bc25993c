"""repro_torch.core.secagg against repro.core.secagg, on the CPU.

The port draws each pair's pad from its own Philox stream where the
reference folds the pair into a threefry key, so the ciphertexts differ;
the masks cancel exactly in Z_2^32 either way, so every sum and every
decoded total must be the reference's bit for bit on the same numpy
inputs.  Errors are the reference's too: each case that raises
``ValueError`` there raises it here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import secagg as jsecagg
from repro_torch.core import secagg


def _tree(rng, scale=1.0):
    """Leaves that are 2-D, a scalar, empty, and nested."""
    return {
        "w": (rng.normal(0, 3, (3, 4)) * scale).astype(np.float32),
        "s": np.float32(rng.normal(0, 2) * scale).reshape(()),
        "e": np.zeros((0,), np.float32),
        "b": {"c": (rng.normal(0, 1, 5) * scale).astype(np.float32)},
    }


def _leaves(tree, prefix=""):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(ours, ref):
    a, b = _leaves(ours), _leaves(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("frac_bits", [8, 16])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_secure_sum_is_the_references_bit_for_bit(n, frac_bits):
    rng = np.random.default_rng(100 * n + frac_bits)
    trees = [_tree(rng, scale=10.0 ** (i % 3 - 1)) for i in range(n)]
    ours = secagg.secure_sum(trees, secagg.SecAggConfig(n, frac_bits,
                                                        seed=n))
    ref = jsecagg.secure_sum(trees, jsecagg.SecAggConfig(n, frac_bits,
                                                         seed=n))
    _assert_trees_equal(ours, ref)
    # the total is the fixed-point sum: within n half-steps of the plain one
    plain = np.sum([t["w"].astype(np.float64) for t in trees], axis=0)
    assert np.max(np.abs(ours["w"].numpy() - plain)) <= \
        n * 2.0 ** -(frac_bits + 1) + 1e-6 * np.max(np.abs(plain))
    assert ours["e"].shape == (0,) and ours["s"].shape == ()
    # tensors in (as payloads may be) give the same total as numpy in
    tensors = [{"w": torch.from_numpy(t["w"]), "s": torch.tensor(t["s"]),
                "e": torch.zeros(0), "b": {"c": torch.from_numpy(t["b"]["c"])}}
               for t in trees]
    _assert_trees_equal(secagg.secure_sum(
        tensors, secagg.SecAggConfig(n, frac_bits, seed=n + 1)), ref)


@pytest.mark.parametrize("sizes,seed", [
    ([3], 0), ([0, 0], 1), ([5, 17, 0, 9], 2), ([1 << 27] * 3 + [7], 3),
    ([366_390_673, 17], 0), (list(range(12)), 41),
])
def test_secure_sum_ints_is_the_references_and_exact(sizes, seed):
    ours = secagg.secure_sum_ints(sizes, n_participants=len(sizes),
                                  seed=seed)
    assert ours == jsecagg.secure_sum_ints(sizes, n_participants=len(sizes),
                                           seed=seed) == sum(sizes)
    assert type(ours) is int


def test_net_masks_cancel_and_uploads_are_masked():
    cfg = secagg.SecAggConfig(5, frac_bits=16, seed=7)
    session = secagg.SecAggSession(cfg, {"w": np.zeros((64,), np.float32),
                                         "b": np.zeros((), np.float32)})
    with np.errstate(over="ignore"):
        total = sum(np.concatenate([m.ravel() for m in session.mask_for(i)]
                                   ).astype(np.uint64)
                    for i in range(5)) % (1 << 32)
    assert (total == 0).all()
    x = {"w": np.ones((64,), np.float32), "b": np.float32(2.0).reshape(())}
    up = session.upload(0, x)[0]
    plain = np.round(np.ones(64) * cfg.scale).astype(np.uint32)
    assert (up != plain).mean() > 0.9
    # the port's pads are its own: ciphertexts differ from the reference's
    ref_up = jsecagg.SecAggSession(
        jsecagg.SecAggConfig(5, 16, seed=7),
        {"w": jnp.zeros((64,)), "b": jnp.zeros(())}).upload(0, x)
    assert not np.array_equal(up, ref_up[1])  # jax sorts keys: b, w


def test_pad_chunk_pairs_changes_no_bit():
    rng = np.random.default_rng(3)
    trees = [{"w": rng.normal(0, 1, (6, 5)).astype(np.float32)}
             for _ in range(6)]
    sessions = [secagg.SecAggSession(
        secagg.SecAggConfig(6, seed=9, pad_chunk_pairs=c), trees[0])
        for c in (1024, 1, 4)]
    masks = [s._flat_masks() for s in sessions]
    for m in masks[1:]:
        np.testing.assert_array_equal(m, masks[0])
    ups = [s.upload_all(dict(enumerate(trees))) for s in sessions]
    for u in ups[1:]:
        for i in range(6):
            np.testing.assert_array_equal(u[i][0], ups[0][i][0])
    # upload_all is per-participant upload, bit for bit
    for i in range(6):
        np.testing.assert_array_equal(sessions[0].upload(i, trees[i])[0],
                                      ups[0][i][0])


@pytest.mark.parametrize("frac_bits", [0, 8, 16, 20])
def test_encode_decode_round_trip_is_the_references(frac_bits):
    x = np.concatenate([
        np.random.default_rng(frac_bits).normal(0, 100, 500),
        [0.0, -0.0, 0.5, -0.5, 1.5, -2.5, 2**-frac_bits / 2, 1e-9],
    ]).astype(np.float32)
    cfg = secagg.SecAggConfig(2, frac_bits=frac_bits)
    jcfg = jsecagg.SecAggConfig(2, frac_bits=frac_bits)
    enc = secagg._encode(x, cfg)
    np.testing.assert_array_equal(enc, jsecagg._encode(x, jcfg))
    dec = secagg._decode(enc, cfg)
    np.testing.assert_array_equal(dec, jsecagg._decode(enc, jcfg))
    # decode(encode(x)) is x on the fixed-point grid, half to even
    want = (np.round(x.astype(np.float64) * cfg.scale) / cfg.scale
            ).astype(np.float32)
    np.testing.assert_array_equal(dec, want)


def _short_list(mod):
    mod.secure_sum([np.ones(3, np.float32)] * 2, mod.SecAggConfig(3))


def _empty_list(mod):
    mod.secure_sum([], mod.SecAggConfig(2))


def _missing_upload(mod):
    tmpl = np.zeros((4,), np.float32)
    session = mod.SecAggSession(mod.SecAggConfig(3), tmpl)
    session.aggregate([session.upload(i, np.ones(4, np.float32))
                       for i in range(2)])


def _misshapen_leaf(mod):
    tmpl = {"w": np.zeros((4,), np.float32)}
    session = mod.SecAggSession(mod.SecAggConfig(2), tmpl)
    ups = [session.upload(i, {"w": np.ones(4, np.float32)}) for i in range(2)]
    ups[1] = [ups[1][0][:3]]
    session.aggregate(ups)


def _misshapen_value(mod):
    session = mod.SecAggSession(mod.SecAggConfig(2),
                                {"w": np.zeros((4,), np.float32)})
    session.upload(0, {"w": np.ones((5,), np.float32)})


def _negative_int(mod):
    mod.secure_sum_ints([3, -1], n_participants=2)


def _overflowing_int(mod):
    mod.secure_sum_ints([1 << 30, 1 << 30], n_participants=2)


def _short_ints(mod):
    mod.secure_sum_ints([1, 2], n_participants=3)


@pytest.mark.parametrize("case", [
    _short_list, _empty_list, _missing_upload, _misshapen_leaf,
    _misshapen_value, _negative_int, _overflowing_int, _short_ints,
], ids=lambda f: f.__name__.strip("_"))
def test_errors_raise_as_the_references(case):
    with pytest.raises(ValueError):
        case(jsecagg)
    with pytest.raises(ValueError):
        case(secagg)


def test_totals_are_float32_tensors_on_the_template_device():
    trees = [{"w": torch.ones(3), "b": torch.tensor(0.25)}] * 2
    out = secagg.secure_sum(trees, secagg.SecAggConfig(2))
    assert out["w"].dtype == torch.float32 and out["w"].device.type == "cpu"
    torch.testing.assert_close(out["w"], torch.full((3,), 2.0))
    assert float(out["b"]) == 0.5
    # numpy payloads carry no device: the caller names it
    out = secagg.secure_sum([{"w": np.ones(3, np.float32)}] * 2,
                            secagg.SecAggConfig(2), device="cpu")
    assert isinstance(out["w"], torch.Tensor)


@pytest.mark.parametrize("n_params,n", [(166_771, 8), (15_659_504, 5)])
def test_message_bytes_are_the_references(n_params, n):
    assert secagg.secagg_message_bytes(n_params, n) == \
        jsecagg.secagg_message_bytes(n_params, n)

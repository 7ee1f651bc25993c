"""Dropout-robust SecAgg and the noise top-up of the port, on the CPU.

``DropoutRobustSession`` draws its DH secrets and Shamir shares from the
reference's numpy generator, so public keys, shares, reconstructions and
the wire-cost model are the reference's bit for bit.  The pads are the
port's own (Philox seeded by each DH agreement, where the reference keys
threefry with the agreement's words): ciphertexts differ, but the masks
cancel exactly in Z_2^32, so every decoded sum — with any set of dropped
participants the threshold allows, the dropped pads rebuilt from the
survivors' shares — is the reference's bit for bit, and every refusal is
the reference's ``ValueError``.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import dp as jdp
from repro.core import secagg as jsecagg
from repro_torch.core import dp, secagg


def _tree(rng, scale=1.0):
    """Leaves that are 2-D, a scalar, empty, and nested."""
    return {
        "w": (rng.normal(0, 3, (3, 4)) * scale).astype(np.float32),
        "s": np.float32(rng.normal(0, 2) * scale).reshape(()),
        "e": np.zeros((0,), np.float32),
        "b": {"c": (rng.normal(0, 1, 5) * scale).astype(np.float32)},
    }


def _assert_equal(ours, ref):
    a = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), ours))
    b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ref))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("threshold", [1, 2, 4, 7])
def test_shamir_is_the_references(threshold):
    secret = 0x1234_5678_9ABC_DEF % ((1 << 61) - 1)
    ours = secagg.shamir_share(secret, 7, threshold,
                               np.random.default_rng(3))
    ref = jsecagg.shamir_share(secret, 7, threshold,
                               np.random.default_rng(3))
    assert ours == ref
    for subset in itertools.combinations(ours, threshold):
        assert secagg.shamir_reconstruct(subset) == secret == \
            jsecagg.shamir_reconstruct(subset)
    if threshold > 1:   # fewer shares than the threshold miss the secret
        assert secagg.shamir_reconstruct(ours[:threshold - 1]) != secret


def test_shamir_errors_are_the_references():
    for call in (lambda m: m.shamir_share(-1, 3, 2, np.random.default_rng()),
                 lambda m: m.shamir_share(1 << 61, 3, 2,
                                          np.random.default_rng()),
                 lambda m: m.shamir_share(5, 3, 4, np.random.default_rng()),
                 lambda m: m.shamir_share(5, 3, 0, np.random.default_rng()),
                 lambda m: m.shamir_reconstruct([]),
                 lambda m: m.shamir_reconstruct([(1, 2), (1, 3)])):
        with pytest.raises(ValueError) as e1:
            call(secagg)
        with pytest.raises(ValueError) as e2:
            call(jsecagg)
        assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("n,threshold", [(2, None), (3, None), (5, 2),
                                         (6, 6)])
def test_keys_and_shares_are_the_references(n, threshold):
    tmpl = _tree(np.random.default_rng(0))
    ours = secagg.DropoutRobustSession(secagg.SecAggConfig(n, seed=41 + n),
                                       tmpl, threshold=threshold)
    ref = jsecagg.DropoutRobustSession(jsecagg.SecAggConfig(n, seed=41 + n),
                                       tmpl, threshold=threshold)
    assert ours.threshold == ref.threshold
    assert ours.public_keys == ref.public_keys
    assert ours._secret_keys == ref._secret_keys
    assert ours._shares == ref._shares
    for i, j in itertools.permutations(range(n), 2):
        assert ours._pair_seed(i, j) == ours._pair_seed(j, i) == \
            ref._pair_seed(i, j)
    # the net masks cancel exactly in the field
    with np.errstate(over="ignore"):
        total = np.sum(ours._flat_masks(), axis=0, dtype=np.uint32)
    assert not total.any()


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_sums_with_dropouts_are_the_references_bit_for_bit(n):
    """Every dropped set the (majority) threshold allows, including none;
    two frac_bits settings and values across three scales."""
    rng = np.random.default_rng(n)
    values = [_tree(rng, scale=10.0 ** (i % 3 - 1)) for i in range(n)]
    threshold = n // 2 + 1
    cases = 0
    for frac_bits in (8, 16):
        for k in range(n - threshold + 1):
            for dropped in itertools.combinations(range(n), k):
                slots = [None if i in dropped else v
                         for i, v in enumerate(values)]
                ours = secagg.secure_sum_with_dropouts(
                    slots, secagg.SecAggConfig(n, frac_bits, seed=7))
                ref = jsecagg.secure_sum_with_dropouts(
                    slots, jsecagg.SecAggConfig(n, frac_bits, seed=7))
                _assert_equal(ours, ref)
                # = the fixed-point sum of the survivors' values
                plain = sum(v["w"].astype(np.float64)
                            for v in slots if v is not None)
                assert np.max(np.abs(ours["w"].numpy() - plain)) <= \
                    n * 2.0 ** -(frac_bits + 1) + 1e-6 * np.abs(plain).max()
                cases += 1
    assert cases == 2 * sum(len(list(itertools.combinations(range(n), k)))
                            for k in range(n - threshold + 1))


def test_recovery_rebuilds_the_dropped_pads_once():
    """``recover`` (what the backend times as ``secagg.recover``) gives
    the field vector ``aggregate`` applies: computed once per survivor
    set, and the total equal to the reference's either way."""
    rng = np.random.default_rng(11)
    values = [_tree(rng) for _ in range(5)]
    cfg = secagg.SecAggConfig(5, seed=3)
    session = secagg.DropoutRobustSession(cfg, values[0])
    uploads = session.upload_all({i: values[i] for i in (0, 2, 3, 4)})
    fix = session.recover([0, 2, 3, 4])
    assert session.recover([4, 3, 2, 0]) is fix
    total = session.aggregate(uploads)
    ref = jsecagg.secure_sum_with_dropouts(
        [values[0], None, values[2], values[3], values[4]],
        jsecagg.SecAggConfig(5, seed=3))
    _assert_equal(total, ref)
    # device tensors in, the total on the template's device
    tensors = {i: jax.tree_util.tree_map(
                  lambda a: torch.as_tensor(np.asarray(a)), values[i])
               for i in (0, 2, 3, 4)}
    session = secagg.DropoutRobustSession(cfg, tensors[0])
    _assert_equal(session.aggregate(session.upload_all(tensors)), ref)


def test_dropout_errors_are_the_references():
    rng = np.random.default_rng(1)
    v = [_tree(rng) for _ in range(4)]
    for call in (
        lambda m: m.DropoutRobustSession(m.SecAggConfig(1), v[0]),
        lambda m: m.DropoutRobustSession(m.SecAggConfig(4), v[0],
                                         threshold=1),
        lambda m: m.DropoutRobustSession(m.SecAggConfig(4), v[0],
                                         threshold=5),
        lambda m: m.secure_sum_with_dropouts(v[:3], m.SecAggConfig(4)),
        lambda m: m.secure_sum_with_dropouts([None] * 4, m.SecAggConfig(4)),
        # below the threshold (3 of 4): the dropped masks cannot be rebuilt
        lambda m: m.secure_sum_with_dropouts([v[0], None, None, v[3]],
                                             m.SecAggConfig(4)),
        lambda m: m.secure_sum_with_dropouts([v[0], None, None, None],
                                             m.SecAggConfig(4),
                                             threshold=2),
        lambda m: m.DropoutRobustSession(m.SecAggConfig(3), v[0]).aggregate(
            {0: [np.zeros(1, np.uint32)], 1: [], 2: []}),
        lambda m: m.DropoutRobustSession(m.SecAggConfig(2), v[0]).aggregate(
            {0: None, 5: None}),
    ):
        with pytest.raises(ValueError) as e1:
            call(secagg)
        with pytest.raises(ValueError) as e2:
            call(jsecagg)
        assert str(e1.value) == str(e2.value)


@pytest.mark.parametrize("n,d", [(2, 0), (3, 1), (5, 2), (8, 7), (50, 3)])
def test_recovery_bytes_are_the_references(n, d):
    assert secagg.secagg_recovery_bytes(n, d) == \
        jsecagg.secagg_recovery_bytes(n, d)


def test_topup_noise_has_the_missing_variance():
    """The top-up is N(0, (C sigma)^2 missing / n): 400,000 draws put the
    sample variance's standard error at 0.22%; the bound is 2%."""
    clip, sigma, missing, n = 1.5, 0.8, 2, 5
    gen = torch.Generator().manual_seed(dp.noise_seed(7, dp.TOPUP_STREAM, 1))
    template = {"w": torch.zeros(200, 1000), "b": {"c": torch.zeros(200_000)}}
    topup = dp.tree_topup_noise(template, gen, clip_norm=clip,
                                noise_multiplier=sigma, missing=missing,
                                n_shares=n)
    assert topup["w"].shape == (200, 1000) and topup["w"].dtype == \
        torch.float32
    draws = torch.cat([topup["w"].reshape(-1), topup["b"]["c"]]).double()
    want = (clip * sigma) ** 2 * missing / n
    assert abs(float(draws.var()) / want - 1.0) < 0.02
    assert abs(float(draws.mean())) < 0.01
    assert dp.TOPUP_STREAM == jdp.TOPUP_SALT


@pytest.mark.parametrize("missing,n", [(0, 3), (4, 3), (-1, 2)])
def test_topup_errors_are_the_references(missing, n):
    with pytest.raises(ValueError) as e1:
        dp.tree_topup_noise({"w": torch.zeros(3)}, torch.Generator(),
                            clip_norm=1.0, noise_multiplier=1.0,
                            missing=missing, n_shares=n)
    with pytest.raises(ValueError) as e2:
        jdp.tree_topup_noise({"w": np.zeros(3, np.float32)},
                             jax.random.key(0), clip_norm=1.0,
                             noise_multiplier=1.0, missing=missing,
                             n_shares=n)
    assert str(e1.value) == str(e2.value)

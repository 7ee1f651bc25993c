"""The tabular slice of repro_torch against the JAX reference, on the CPU.

The synthetic hospital data, the partitions and the preparation-phase
normalisation are numpy in both packages and must give the same arrays
bit for bit.  Every tabular model runs with the reference's weights,
carried across by ``tabular_params_from_jax``: per-example losses,
predictions and gradients within 1e-5 in float32, the faithful
per-example clipped sum within 1e-5 of the reference's, and the MLP ghost
path within 1e-5 of both the reference's and the port's per-example sum.
The DenseNet runs at the scenarios' "small" preset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.arms as jarms
from repro.core import dp as jdp
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import tabular as jtab
import repro_torch.arms as arms
from repro_torch.convert import tabular_params_from_jax, tabular_params_to_numpy
from repro_torch.core import dp
from repro_torch.data import partition, synthetic
from repro_torch.models import tabular

torch.set_num_threads(1)

ATOL = 1e-5


def _assert_silos_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert type(a).__module__.startswith("repro_torch")
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("name,kw", [
    ("make_gemini_like", dict(seed=0, n_total=600, n_silos=4, n_features=16)),
    ("make_gemini_like", dict(seed=3, n_total=900, n_silos=10,
                              n_features=24)),
    ("make_gemini_like", dict(seed=0)),
    ("make_pancreas_like", dict(seed=0, n_total=600, n_genes=128)),
    ("make_pancreas_like", dict(seed=2, n_total=300, n_silos=7, n_genes=64,
                                n_types=3)),
    ("make_xray_like", dict(seed=0, n_total=300, image_size=16)),
    ("make_xray_like", dict(seed=1, n_total=200, n_silos=4, image_size=8)),
])
def test_generators_are_the_references(name, kw):
    _assert_silos_equal(getattr(synthetic, name)(**kw),
                        getattr(jsynthetic, name)(**kw))


def test_lm_stream_is_the_references():
    ours = synthetic.make_lm_stream(97, 12, seed=4).batch(3, 5)
    ref = jsynthetic.make_lm_stream(97, 12, seed=4).batch(3, 5)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(ours[k], ref[k])


def test_partitions_and_normalisation_are_the_references():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (300, 6)).astype(np.float32)
    y = rng.integers(0, 3, 300).astype(np.int32)
    _assert_silos_equal(
        partition.sized_partition(x, y, [0.5, 0.3, 0.2], seed=1),
        jpartition.sized_partition(x, y, [0.5, 0.3, 0.2], seed=1))
    _assert_silos_equal(
        partition.dirichlet_partition(x, y, 4, alpha=0.3, seed=2),
        jpartition.dirichlet_partition(x, y, 4, alpha=0.3, seed=2))
    silos = synthetic.make_gemini_like(seed=0, n_total=600, n_silos=4,
                                       n_features=16)
    jsilos = jsynthetic.make_gemini_like(seed=0, n_total=600, n_silos=4,
                                         n_features=16)
    train, tx, ty = partition.train_test_split_silos(silos, 0.2, seed=5)
    jtrain, jtx, jty = jpartition.train_test_split_silos(jsilos, 0.2, seed=5)
    _assert_silos_equal(train, jtrain)
    np.testing.assert_array_equal(tx, jtx)
    np.testing.assert_array_equal(ty, jty)
    _assert_silos_equal(arms.normalize_participants(silos),
                        jarms.normalize_participants(jsilos))


# -- the models, with the reference's weights carried across ------------------

DENSENET_SMALL = dict(growth=4, blocks=(1, 1), init_channels=8, image_size=16)


MODELS = {
    # name: (constructor(module, device kw), data kind, feature count)
    "linear": (lambda m, **d: m.linear_model(16, **d), "binary", 16),
    # zero weights: every logit is exactly 0, where |x| and max(x, 0) tie
    "linear_at_zero": (lambda m, **d: m.linear_model(16, **d), "binary", 16),
    "logistic": (lambda m, **d: m.make_logistic(16, **d), "binary", 16),
    "mlp_binary": (lambda m, **d: m.make_mlp_classifier(
        [16, 12, 8, 1], "binary", **d), "binary", 16),
    "mlp_multiclass": (lambda m, **d: m.make_mlp_classifier(
        [24, 16, 4], "multiclass", **d), "multiclass", 24),
    "svc": (lambda m, **d: m.make_svc(24, 4, **d), "multiclass", 24),
    "densenet_small": (lambda m, **d: m.make_densenet(
        m.DenseNetConfig(**DENSENET_SMALL), **d), "image", 16),
}


def _batch(kind, f, n=10, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "image":
        x = rng.normal(0.5, 0.3, (n, f, f, 1)).astype(np.float32)
        y = (rng.random((n, 4)) < 0.3).astype(np.float32)
    else:
        x = rng.normal(0, 1.5, (n, f)).astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32) if kind == "binary" \
            else rng.integers(0, 4, n).astype(np.int32)
    return {"x": x, "y": y}


def _random_weights(tree, seed):
    """Non-zero weights for the zero-initialised linear model."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.5, np.shape(a)).astype(np.float32), tree)


def _pair(name):
    make, kind, f = MODELS[name]
    jmodel, tmodel = make(jtab), make(tabular, device="cpu")
    p0 = jax.tree_util.tree_map(np.asarray, jmodel.init_fn(jax.random.key(1)))
    if name == "linear":
        p0 = _random_weights(p0, 1)
    return jmodel, tmodel, p0, tabular_params_from_jax(p0, device="cpu"), \
        _batch(kind, f)


def _close(ours, ref, atol=ATOL):
    ref = jax.tree_util.tree_map(np.asarray, ref)
    flat_ours = jax.tree_util.tree_leaves(ours)
    flat_ref = jax.tree_util.tree_leaves(ref)
    assert len(flat_ours) == len(flat_ref)
    for a, b in zip(flat_ours, flat_ref):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_carry_across_with_layout_and_dtype_kept(name):
    jmodel, tmodel, p0, tp, _ = _pair(name)
    back = tabular_params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(p0)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(p0)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own seeded init has the reference's layout
    own = tmodel.init_fn(0)
    for a, b in zip(jax.tree_util.tree_leaves(tabular_params_to_numpy(own)),
                    jax.tree_util.tree_leaves(p0)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("name", sorted(MODELS))
def test_per_example_loss_predictions_and_grads_match(name):
    jmodel, tmodel, p0, tp, batch = _pair(name)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss = jax.vmap(jmodel.loss_fn, in_axes=(None, 0))(p0, jb)
    tloss = torch.func.vmap(tmodel.loss_fn, in_dims=(None, 0))(tp, tb)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=ATOL,
                               rtol=0)
    # one example at a time, outside vmap, as well
    one = {k: v[0] for k, v in tb.items()}
    np.testing.assert_allclose(float(tmodel.loss_fn(tp, one)),
                               float(jloss[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tmodel.predict_fn(tp, tb["x"]).detach().numpy(),
        np.asarray(jmodel.predict_fn(p0, jb["x"])), atol=ATOL, rtol=0)
    jg = jax.vmap(jax.grad(jmodel.loss_fn), in_axes=(None, 0))(p0, jb)
    tg = torch.func.vmap(torch.func.grad(tmodel.loss_fn),
                         in_dims=(None, 0))(tp, tb)
    _close(tg, jg)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_per_example_clipped_grad_sum_matches(name):
    jmodel, tmodel, p0, tp, batch = _pair(name)
    mask = np.array([1] * 7 + [0] * 3, np.float32)
    jsum, jl = jdp.per_example_clipped_grad_sum(
        jmodel.loss_fn, p0, jax.tree_util.tree_map(jnp.asarray, batch),
        clip_norm=0.5, microbatch_size=4, mask=jnp.asarray(mask))
    tsum, tl = dp.per_example_clipped_grad_sum(
        tmodel.loss_fn, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        clip_norm=0.5, microbatch_size=4, mask=torch.from_numpy(mask))
    _close(tsum, jsum)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,sizes,task", [
    ("mlp_binary", [16, 12, 8, 1], "binary"),
    ("mlp_multiclass", [24, 16, 4], "multiclass"),
])
def test_ghost_mlp_matches_reference_and_per_example(name, sizes, task):
    jmodel, tmodel, p0, tp, batch = _pair(name)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jg, jn = jtab.ghost_clipped_grad_sum_mlp(
        p0, jax.tree_util.tree_map(jnp.asarray, batch), sizes, task, 0.5)
    tg, tn = tabular.ghost_clipped_grad_sum_mlp(tp, tb, sizes, task, 0.5)
    _close(tg, jg)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=ATOL,
                               rtol=1e-5)
    pe, _ = dp.per_example_clipped_grad_sum(tmodel.loss_fn, tp, tb,
                                            clip_norm=0.5, microbatch_size=5)
    _close(tg, tabular_params_to_numpy(pe))
    # and the norms are the per-example gradients' own
    grads = torch.func.vmap(torch.func.grad(tmodel.loss_fn),
                            in_dims=(None, 0))(tp, tb)
    norms = torch.func.vmap(dp.global_l2_norm)(grads)
    np.testing.assert_allclose(tn.numpy(), norms.numpy(), rtol=1e-5)


def test_pooled_accuracy_is_the_references():
    jmodel, tmodel, p0, tp, _ = _pair("mlp_binary")
    silos = synthetic.make_gemini_like(seed=0, n_total=300, n_silos=3,
                                       n_features=16)
    jsilos = jsynthetic.make_gemini_like(seed=0, n_total=300, n_silos=3,
                                         n_features=16)
    assert tabular.pooled_accuracy(tmodel, tp, silos) == \
        jtab.pooled_accuracy(jmodel, p0, jsilos)


def test_constructors_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make, _, _ in MODELS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(tabular)
        params = make(tabular, device="cpu").init_fn(0)
        assert all(t.device.type == "cpu" and t.dtype == torch.float32
                   for t in jax.tree_util.tree_leaves(params))

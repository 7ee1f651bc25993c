"""repro_torch.core.decaph_step against the JAX reference, on the CPU.

``make_train_step`` in every mode of the reference's (``per_example``,
``group``, ``none``)
on ``smollm-360m``'s smoke config, both packages starting from the
reference's weights (carried across by ``convert``) and taking the same
three batches: at sigma = 0 the parameters after each step within 1e-5
(atol) and the losses at rtol 1e-5.  The steps update with momentum:
Adam's first steps are lr * g / (|g| + eps), about lr * sign(g), which
turns a float32 ulp of a near-zero gradient into a change of lr (the
optimizers themselves are held to 1e-6 in ``test_torch_optim.py``).
JAX's threefry noise cannot be reproduced by a torch generator, so at
sigma > 0 the aggregate draw is held to its law: two steps from the same point with two generators differ
by noise of variance 2 (lr C sigma / B)^2 per coordinate (SGD), within 2%
over the model's ~400,000 coordinates (the estimate's spread is ~0.2%).
The clipped sum's ``accum_dtype`` reaches ``core.dp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import decaph_step as jstep
from repro.core.dp import DPConfig as JDPConfig
from repro.models import transformer as jtf
from repro.optim import get_optimizer as jax_optimizer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import decaph_step, dp
from repro_torch.models import transformer as tf
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ATOL = 1e-5
LOSS_RTOL = 1e-5
ARCH = "smollm-360m"
B, S = 4, 12
STEPS = 3


def _batches(vocab: int) -> list[dict]:
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
        labels[:, -2:] = -1
        out.append({"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
                    "labels": labels})
    return out


def _close(tparams, tcfg, jparams) -> None:
    ours = jax.tree_util.tree_leaves(params_to_numpy(tparams, tcfg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["per_example", "group", "none"])
def test_steps_match_reference_at_sigma_zero(mode):
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams = jtf.init(jcfg, jax.random.key(2))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    # microbatch 3 does not divide the batch of 4: one padded microbatch
    jdp = JDPConfig(clip_norm=0.5, noise_multiplier=0.0, microbatch_size=3)
    tdp = dp.DPConfig(clip_norm=0.5, noise_multiplier=0.0, microbatch_size=3)
    jopt = jax_optimizer("momentum", 0.05)
    topt = get_optimizer("momentum", 0.05)
    jfn = jax.jit(jstep.make_train_step(
        lambda p, b: jtf.loss_fn(jcfg, p, b),
        lambda p, ex: jtf.per_example_loss_fn(jcfg, p, ex),
        jopt, jstep.DeCaPHStepConfig(dp=jdp, mode=mode, global_batch=8)))
    tfn = decaph_step.make_train_step(
        lambda p, b: tf.loss_fn(tcfg, p, b),
        lambda p, ex: tf.per_example_loss_fn(tcfg, p, ex),
        topt, decaph_step.DeCaPHStepConfig(dp=tdp, mode=mode, global_batch=8))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    gen = torch.Generator().manual_seed(0)
    for i, batch in enumerate(_batches(tcfg.vocab_size)):
        jparams, jstate, jm = jfn(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(i))
        tparams, tstate, tm = tfn(
            tparams, tstate, {k: torch.from_numpy(v) for k, v in
                              batch.items()}, gen)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        _close(tparams, tcfg, jparams)


@pytest.mark.parametrize("mode", ["per_example", "group"])
def test_aggregate_noise_has_the_mechanism_variance(mode):
    cfg = get_smoke_config(ARCH)
    params = tf.init(cfg, 1, "cpu")
    lr, clip, sigma, batch_b = 0.5, 0.7, 1.3, 8
    step = decaph_step.make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b),
        lambda p, ex: tf.per_example_loss_fn(cfg, p, ex),
        get_optimizer("sgd", lr),
        decaph_step.DeCaPHStepConfig(
            dp=dp.DPConfig(clip_norm=clip, noise_multiplier=sigma,
                           microbatch_size=4),
            mode=mode, global_batch=batch_b))
    batch = {k: torch.from_numpy(v) for k, v in
             _batches(cfg.vocab_size)[0].items()}
    outs = [step(params, (), batch, torch.Generator().manual_seed(s))[0]
            for s in (1, 2)]
    diff = torch.cat([(a - b).double().flatten() for a, b in
                      zip(tree_leaves(outs[0]), tree_leaves(outs[1]))])
    want = 2 * (lr * clip * sigma / batch_b) ** 2
    assert diff.numel() > 300_000
    assert abs(float(diff.var()) / want - 1) < 0.02
    assert abs(float(diff.mean())) < 4 * (want / diff.numel()) ** 0.5


def test_unknown_mode_raises():
    cfg = get_smoke_config(ARCH)
    step = decaph_step.make_train_step(
        None, None, get_optimizer("sgd", 0.1),
        decaph_step.DeCaPHStepConfig(dp=dp.DPConfig(), mode="dense"))
    with pytest.raises(ValueError, match="unknown mode"):
        step(tf.init(cfg, 0, "cpu"), (), {}, torch.Generator())


def test_ghost_mode_needs_a_ghost_grad_sum():
    """Mode "ghost" (the port's own, the launch layer's ghost program)
    takes its clipped sum from the caller and refuses to build without."""
    with pytest.raises(ValueError, match="ghost_grad_sum"):
        decaph_step.make_train_step(
            None, None, get_optimizer("sgd", 0.1),
            decaph_step.DeCaPHStepConfig(dp=dp.DPConfig(), mode="ghost"))


@pytest.mark.parametrize("accum", [torch.float32, torch.float64])
def test_clipped_sum_accumulates_in_accum_dtype(accum):
    torch.manual_seed(0)
    params = {"w": torch.randn(5, 3), "b": torch.randn(3)}
    x = torch.randn(6, 5)

    def loss(p, ex):
        return torch.sum(torch.tanh(ex @ p["w"] + p["b"]) ** 2)

    g_sum, mean = dp.per_example_clipped_grad_sum(
        loss, params, x, clip_norm=0.3, microbatch_size=4,
        accum_dtype=accum)
    assert all(t.dtype == accum for t in tree_leaves(g_sum))
    assert mean.dtype == accum
    ref, ref_mean = dp.per_example_clipped_grad_sum(
        loss, params, x, clip_norm=0.3, microbatch_size=4)
    for a, b in zip(tree_leaves(g_sum), tree_leaves(ref)):
        torch.testing.assert_close(a.float(), b, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(mean.float(), ref_mean, rtol=1e-6, atol=0)

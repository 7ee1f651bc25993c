"""At the configurations' smoke widths on the CPU, the plain references
agree with the port's plain path: a sigma = 0 DeCaPH round, and one loss
forward."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import checks, generate, spec
from perfbench.harness.port import model_config
from perfbench.tests._smoke import smoke_config

CONFIGS = ["smollm-360m", "olmo-1b"]


def _mc(name):
    return {**spec.config(name), **smoke_config(spec.config(name))}


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_forward_agrees(name):
    from repro_torch.models import transformer as tf

    mc = _mc(name)
    params = generate.make_params(mc, 2**31 + 21, "cpu")
    x = generate.token_silos(mc["vocab_size"], hospitals=2, n_per=2,
                             seq_len=24, seed=5)
    batch = {"tokens": torch.from_numpy(np.concatenate([s[0] for s in x])),
             "labels": torch.from_numpy(np.concatenate([s[1] for s in x]))}
    with torch.no_grad():
        port = float(tf.loss_fn(model_config(mc), params, batch))
    ref = spec.reference("eval").batch_losses(mc, params, [batch])[0]
    assert port == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_sigma_zero_decaph_round_agrees(name):
    import repro_torch.arms as arms
    from repro_torch.core.dp import DPConfig
    from repro_torch.serve.federation import transformer_model

    mc = _mc(name)
    mix = {**spec.traffic("decaph-s256-b8"), "n_per": 32, "seq_len": 12,
           "batch_size": 8, "noise_multiplier": 0.0}
    params0 = generate.make_params(mc, 2**31 + 22, "cpu")
    data = generate.token_silos(mc["vocab_size"], hospitals=4,
                                n_per=mix["n_per"], seq_len=mix["seq_len"],
                                seed=9)
    model = dataclasses.replace(
        transformer_model(model_config(mc), device="cpu"),
        init_fn=lambda _seed: params0)
    cfg = arms.ArmConfig(rounds=1, batch_size=8, lr=mix["lr"],
                         seed=mix["protocol_seed"], use_secagg=False,
                         clipping="ghost",
                         dp=DPConfig(clip_norm=1.0, noise_multiplier=0.0))
    report = arms.run("decaph", model, [arms.Participant(*d) for d in data],
                      cfg, backend="ideal")
    ref = spec.reference("decaph_train").follow(
        mc, mix, params0, data, mix["protocol_seed"], rounds=1)
    p0 = generate.leaves(params0)
    p1 = generate.leaves(report.params)
    prog = {"loss": [report.logs[0].loss],
            "agg": [report.logs[0].aggregate_batch],
            **checks.program_steps(p0, p1, p1, ref, mix["lr"])}
    numbers = checks.train_numbers(prog, ref)
    assert numbers["agg_mismatch"] == 0
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-4

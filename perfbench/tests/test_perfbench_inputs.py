"""The generator repeats bit for bit from a seed, is the port's generator's
copy, and lays the weights out as the port keeps them."""

import numpy as np
import pytest
import torch

from perfbench.harness import generate, spec
from perfbench.harness.port import model_config
from perfbench.tests._smoke import smoke_config


def test_token_silos_repeat_from_a_seed():
    a = generate.token_silos(512, hospitals=3, n_per=5, seq_len=7,
                             seed=generate.substream(2**31 + 11, 1))
    b = generate.token_silos(512, hospitals=3, n_per=5, seq_len=7,
                             seed=generate.substream(2**31 + 11, 1))
    c = generate.token_silos(512, hospitals=3, n_per=5, seq_len=7,
                             seed=generate.substream(2**31 + 12, 1))
    for (xa, ya), (xb, yb) in zip(a, b):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
        assert np.array_equal(ya[:, :-1], xa[:, 1:])
        assert (ya[:, -1] == -1).all()
    assert not all(np.array_equal(xa, xc) for (xa, _), (xc, _) in zip(a, c))


def test_token_silos_copy_the_ports_draws():
    from repro_torch.serve.federation import token_silos

    mc = model_config(spec.config("smollm-360m")).replace(vocab_size=300)
    port = token_silos(mc, hospitals=2, n_per=4, seq_len=9, seed=77)
    ours = generate.token_silos(300, hospitals=2, n_per=4, seq_len=9,
                                seed=77)
    for p, (x, y) in zip(port, ours):
        assert np.array_equal(p.x, x) and np.array_equal(p.y, y)


def _names(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += _names(v, f"{prefix}{k}/") if isinstance(v, dict) \
            else [prefix + k]
    return out


@pytest.mark.parametrize("name", ["smollm-360m", "olmo-1b"])
def test_weights_repeat_and_follow_the_ports_layout(name):
    from repro_torch.models import transformer as tf

    mc = {**spec.config(name), **smoke_config(spec.config(name))}
    a = generate.make_params(mc, 2**31 + 5, "cpu")
    b = generate.make_params(mc, 2**31 + 5, "cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(generate.leaves(a), generate.leaves(b)))
    specs = tf.param_specs(model_config(mc))
    assert _names(a) == _names(specs)
    for ours, theirs in zip(generate.leaves(a), generate.leaves(specs)):
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype

"""repro_torch.launch.steps' train programs for ``smollm-360m`` against
the reference's, on the CPU.

The ghost, per-example and no-DP programs of ``train_4k`` at smoke size,
each two steps against ``repro.launch.steps.build_program``'s on a
one-device ``Auto`` mesh within 1e-5 (``_torch_launch.run_pair``); the
noise at sigma > 0 is one draw of the mechanism's scale; bad modes and
shapes raise.  The MoE arch is ``test_torch_launch_moe.py``'s.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_launch import B, S, auto_mesh, run_pair
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["ghost", "per_example", "none"])
def test_train_program_matches_reference(mode):
    run_pair(auto_mesh(), "smollm-360m", mode)


def test_train_noise_is_one_draw_of_the_mechanism_scale():
    """At sigma > 0 the update carries N(0, (C sigma / global_batch)^2)
    per coordinate (SGD, lr 1): two generators, the same step, whose
    difference has twice that variance (within 2% over ~400,000
    coordinates)."""
    cfg = get_smoke_config("smollm-360m").replace(
        dp_sigma=0.9, dp_clip=0.6, optimizer="sgd", lr=1.0)
    prog = steps.build_program(cfg, "train_4k", "cpu", dp_mode="ghost")
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jtf.init(jax_smoke_config("smollm-360m"),
                             jax.random.key(0))), cfg, device="cpu")
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(1))
             for k in ("tokens", "labels")}
    outs = [prog.fn(params, (), batch, torch.Generator().manual_seed(s))[0]
            for s in (1, 2)]
    diff = torch.cat([(a - b).double().flatten() for a, b in
                      zip(tree_leaves(outs[0]), tree_leaves(outs[1]))])
    want = 2 * (0.6 * 0.9 / 256) ** 2
    assert abs(float(diff.var()) / want - 1) < 0.02


def test_unknown_dp_mode_and_wrong_kind_raise():
    cfg = get_smoke_config("smollm-360m")
    with pytest.raises(ValueError, match="unknown dp_mode"):
        steps.build_program(cfg, "train_4k", "cpu", dp_mode="group")
    with pytest.raises(ValueError, match="decode shape"):
        steps.build_train_program(cfg, "decode_32k", "cpu")

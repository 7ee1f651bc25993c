"""repro_torch.launch.steps' train programs for ``qwen3-moe-30b-a3b``
against the reference's, on the CPU.

The per-example (``torch.func.vmap`` through the MoE dispatch, one token
group as on one card) and no-DP programs of ``train_4k`` at smoke size,
each two Adafactor steps against ``repro.launch.steps.build_program``'s
on a one-device ``Auto`` mesh within 1e-5 (``_torch_launch.run_pair``);
the ghost program refuses the MoE stack in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch import auto_mesh, programs, run_pair
from repro.optim import get_optimizer as jax_optimizer
from repro_torch.optim import get_optimizer

torch.set_num_threads(1)

ARCH = "qwen3-moe-30b-a3b"


@pytest.mark.parametrize("mode", ["per_example", "none"])
def test_train_program_matches_reference(mode):
    run_pair(auto_mesh(), ARCH, mode)


def test_ghost_refuses_moe_as_the_reference_does():
    mesh = auto_mesh()
    jprog, prog, jparams, params = programs(mesh, ARCH, "ghost")
    batch = {k: np.zeros((2, 8), np.int32) for k in ("tokens", "labels")}
    with pytest.raises(AssertionError, match="dense stacks"), mesh:
        jprog.fn(jparams,
                 jax_optimizer(jprog.cfg.optimizer, 0.1).init(jparams),
                 {k: jnp.asarray(v) for k, v in batch.items()},
                 jnp.zeros((2,), jnp.uint32))
    with pytest.raises(NotImplementedError, match="dense stacks"):
        prog.fn(params, get_optimizer(prog.cfg.optimizer, 0.1).init(params),
                {k: torch.from_numpy(v) for k, v in batch.items()},
                torch.Generator())

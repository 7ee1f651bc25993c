"""One rank of the ``shard`` backend's CPU tests (``test_torch_federated``).

Run as ``python tests/_torch_shard_ranks.py CELL`` in each rank spawned by
``repro_torch.launch.ranks.spawn``; every rank runs the same cells (SPMD)
and rank 0 prints ``RESULT::`` and a JSON object.  Cells:

  * ``arms`` (2 ranks, the ("data",) mesh): every fused-capable arm on
    ``linear_model(8)`` against the port's ``ideal`` (the reference's
    ``tests/test_backends.py`` sizes), the noise of the example split at
    sigma 4, and decaph's sigma-0 parameters for the parent to hold
    against the reference's ``ideal``;
  * ``pod`` (8 ranks, (2, 2, 2) ("pod", "data", "model")): the
    reference's three pod-mesh cells;
  * ``splits`` (4 ranks): the participant split on a (2, 2) ("pod",
    "data") mesh and the example split with a model axis on a (2, 2)
    ("data", "model") mesh.
"""

import json
import sys

from repro_torch.launch.ranks import init_rank

rank, world = init_rank("gloo")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.arms as arms  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.dp import DPConfig  # noqa: E402
from repro_torch.data.synthetic import make_gemini_like  # noqa: E402
from repro_torch.launch.federated import ShardedRunner  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_debug_mesh,
    make_host_data_mesh,
    make_mesh,
)
from repro_torch.models.tabular import linear_model  # noqa: E402
from repro_torch.serve.federation import (  # noqa: E402
    token_silos,
    transformer_model,
)
from repro_torch.tree import tree_leaves  # noqa: E402


def _diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _cell(name, model, silos, cfg, mesh) -> dict:
    ideal = arms.run(name, model, silos, cfg)
    runner = ShardedRunner(mesh=mesh)
    shard = runner.run(arms.get(name)(model, silos, cfg))
    ex = runner.executor
    return {
        "max_abs_diff": _diff(ideal.params, shard.params),
        "rounds": [ideal.rounds_completed, shard.rounds_completed],
        "epsilon": [float(ideal.epsilon), float(shard.epsilon)],
        "losses": [[lg.loss for lg in ideal.logs],
                   [lg.loss for lg in shard.logs]],
        "sharded_puts": ex.sharded_puts,
        "participant_shards": ex.participant_shards,
        "param_shards": ex.param_shards,
        "backend_label": shard.backend,
        "collective_bytes": dict(ex.data.bytes),
    }


def _lm():
    cfg_m = get_smoke_config("smollm-360m").replace(tie_embeddings=False)
    return (transformer_model(cfg_m, device="cpu"),
            token_silos(cfg_m, hospitals=4, n_per=16, seq_len=12, seed=0))


def _lm_cfg(sigma=0.8, **extra):
    return arms.ArmConfig(
        rounds=3, batch_size=16, lr=0.1, seed=0, use_secagg=False,
        dp=DPConfig(clip_norm=1.0, noise_multiplier=sigma,
                    microbatch_size=8), **extra)


def cell_arms() -> dict:
    mesh = make_host_data_mesh(device_type="cpu")
    silos = arms.normalize_participants(
        make_gemini_like(seed=0, n_total=720, n_silos=5, n_features=8))
    model = linear_model(8, device="cpu")
    fused = sorted(n for n in arms.names()
                   if getattr(arms.get(n), "fused_capable", False))
    out = {"arms": fused, "cells": {}}
    for name in fused:
        cfg = arms.ArmConfig(
            rounds=3, batch_size=48, lr=0.3, seed=0, use_secagg=False,
            fl_local_steps=2,
            dp=DPConfig(clip_norm=1.0, noise_multiplier=0.8,
                        microbatch_size=8))
        out["cells"][name] = _cell(name, model, silos, cfg, mesh)
    # the example split's noise: one round at lr 1 of a 4096-wide linear
    # model; (shard(sigma) - shard(0)) * aggregate batch is the round's
    # noise, whose variance is (C sigma)^2 if each slot's share is added
    # once, data-extent times that if every rank added its own
    wide = arms.normalize_participants(
        make_gemini_like(seed=1, n_total=400, n_silos=4, n_features=4096))
    big = linear_model(4096, device="cpu")
    runs = {}
    for sigma in (0.0, 4.0):
        cfg = arms.ArmConfig(
            rounds=1, batch_size=32, lr=1.0, seed=3, use_secagg=False,
            dp=DPConfig(clip_norm=0.5, noise_multiplier=sigma,
                        microbatch_size=8))
        runs[sigma] = ShardedRunner(mesh=mesh).run(
            arms.get("decaph")(big, wide, cfg))
    batch = runs[4.0].logs[0].aggregate_batch
    noise = torch.cat([(a - b).reshape(-1) for a, b in zip(
        tree_leaves(runs[4.0].params), tree_leaves(runs[0.0].params))])
    out["noise_var"] = float((noise * batch).var())
    out["noise_target"] = (0.5 * 4.0) ** 2
    # decaph at sigma 0, for the reference's ideal in the parent
    cfg0 = arms.ArmConfig(
        rounds=3, batch_size=48, lr=0.3, seed=0, use_secagg=False,
        dp=DPConfig(clip_norm=1.0, noise_multiplier=0.0, microbatch_size=8))
    rep = ShardedRunner(mesh=mesh).run(arms.get("decaph")(model, silos, cfg0))
    out["sigma0"] = {k: v.tolist() for k, v in rep.params.items()}
    out["sigma0_eps"] = float(rep.epsilon)
    return out


def cell_pod() -> dict:
    mesh = make_debug_mesh(n_data=2, n_model=2, multi_pod=True,
                           device_type="cpu")
    lm_model, lm_silos = _lm()
    tab_model = linear_model(8, device="cpu")
    tab_silos = arms.normalize_participants(
        make_gemini_like(seed=0, n_total=720, n_silos=4, n_features=8))
    cells = [
        ("decaph-lm-ghost", lm_model, lm_silos, {"clipping": "ghost"}),
        ("decaph-lm-faithful", lm_model, lm_silos,
         {"clipping": "per-example"}),
        ("decaph-tabular", tab_model, tab_silos, {}),
    ]
    return {label: _cell("decaph", model, silos, _lm_cfg(**extra), mesh)
            for label, model, silos, extra in cells}


def ghost_norm_on_dtensors(mesh) -> dict:
    """``ghost_norm`` on the model sub-mesh's shards: a feature split of
    either operand sums to the whole; of both it raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.ghost_norm import ops as ghost_ops

    sub = mesh["model"]
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(3, 16, 8, generator=gen)
    g = torch.randn(3, 16, 6, generator=gen)
    whole = ghost_ops.ghost_norm(a, g)
    out = {}
    for label, pa, pg in (("g-columns", Replicate(), Shard(2)),
                          ("a-columns", Shard(2), Replicate())):
        got = ghost_ops.ghost_norm(distribute_tensor(a, sub, [pa]),
                                   distribute_tensor(g, sub, [pg]))
        out[label] = float((got.full_tensor() - whole).abs().max())
    try:
        ghost_ops.ghost_norm(distribute_tensor(a, sub, [Shard(2)]),
                             distribute_tensor(g, sub, [Shard(2)]))
        out["both"] = "no error"
    except ValueError as e:
        out["both"] = str(e)
    return out


def cell_splits() -> dict:
    lm_model, lm_silos = _lm()
    tab_model = linear_model(8, device="cpu")
    tab_silos = arms.normalize_participants(
        make_gemini_like(seed=0, n_total=720, n_silos=4, n_features=8))
    pod = make_mesh((2, 2), ("pod", "data"), "cpu")
    tp = make_debug_mesh(n_data=2, n_model=2, device_type="cpu")
    return {
        "participant-lm": _cell("decaph", lm_model, lm_silos,
                                _lm_cfg(clipping="ghost"), pod),
        "participant-tabular": _cell("decaph", tab_model, tab_silos,
                                     _lm_cfg(), pod),
        "participant-fedavg": _cell(
            "fedprox", tab_model, tab_silos,
            _lm_cfg(fl_local_steps=2), pod),
        "example-model-lm": _cell("decaph", lm_model, lm_silos,
                                  _lm_cfg(clipping="ghost"), tp),
        "ghost_norm": ghost_norm_on_dtensors(tp),
    }


if __name__ == "__main__":
    result = {"arms": cell_arms, "pod": cell_pod,
              "splits": cell_splits}[sys.argv[1]]()
    if rank == 0:
        print("RESULT::" + json.dumps(result), flush=True)

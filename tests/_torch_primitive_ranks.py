"""One rank of ``test_torch_shard_primitives``: the model primitives the dry
run places, on real DTensors over ``gloo``, held against the same call on
plain tensors.

Run as ``python tests/_torch_primitive_ranks.py`` in each of 4 ranks
spawned by ``repro_torch.launch.ranks.spawn``; every rank runs every
check (SPMD) and rank 0 prints ``RESULT::`` and a JSON object:

  * ``decode_<split>``: ``attention.gqa_decode`` (smoke SmolLM, float32)
    with the KV cache split over "data" by its batch, over "model" by its
    KV heads, or over "data" by its sequence: the K and V rows written and
    the output against the plain call's (``wo`` the identity, so that the
    output is attention's own values; ``_wo`` with a drawn ``wo``, whose
    product DTensor sums over the heads' ranks in another order);
  * ``moe``: ``moe.moe_apply`` (smoke Qwen3-MoE) with the tokens split
    over ("pod", "data") on a (2, 2, 1) mesh, two MoE groups, under the
    reference's activation rules;
  * ``split``: ``layers.split_dim`` inside ``torch.func.vmap`` on a
    DTensor whose 60-wide dim is split over 2 ranks and cut into 15 heads.
"""

import json

from repro_torch.launch.ranks import init_rank

rank, world = init_rank("gloo")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication,
)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention, layers, moe  # noqa: E402


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _place(t, placements, mesh):
    """``t`` (the same on every rank) as a DTensor in ``placements``."""
    return distribute_tensor(t, mesh, placements)


def _max_diff(a, b) -> float:
    return float((a - b).abs().max())


def decode_cells(out: dict) -> None:
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = get_smoke_config("smollm-360m").replace(use_decode_kernel=False)
    b, length = 4, 6
    kv, hd, d = cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    rng = np.random.default_rng(0)
    p = {"wq": _t(rng, d, cfg.n_heads * hd) * 0.1,
         "wk": _t(rng, d, kv * hd) * 0.1, "wv": _t(rng, d, kv * hd) * 0.1}
    x = _t(rng, b, 1, d)
    k0, v0 = _t(rng, b, length, kv, hd), _t(rng, b, length, kv, hd)
    index = torch.tensor([0, 5, 2, 3], dtype=torch.int32)
    wo_drawn = _t(rng, cfg.n_heads * hd, d) * 0.1
    splits = {"batch": [Shard(0), Replicate()],
              "heads": [Replicate(), Shard(2)],
              "sequence": [Shard(1), Replicate()]}
    for wo_name, wo in (("", torch.eye(d)), ("_wo", wo_drawn)):
        params = dict(p, wo=wo)
        ref = {"k": k0.clone(), "v": v0.clone()}
        y_ref, _ = attention.gqa_decode(params, x, ref, index, cfg)
        for name, placements in splits.items():
            cache = {n: _place(t.clone(), placements, mesh)
                     for n, t in (("k", k0), ("v", v0))}
            xs = _place(x, [placements[0] if placements[0].is_shard(0)
                            else Replicate(), Replicate()], mesh)
            with implicit_replication():
                y, _ = attention.gqa_decode(params, xs, cache, index, cfg)
            out[f"decode_{name}{wo_name}"] = {
                "k": _max_diff(cache["k"].full_tensor(), ref["k"]),
                "v": _max_diff(cache["v"].full_tensor(), ref["v"]),
                "y": _max_diff(y.full_tensor(), y_ref),
                "k_local_rows": list(cache["k"].to_local().shape),
            }


def moe_cell(out: dict) -> None:
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(1)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    p = {"w_router": _t(rng, d, e), "w_gate": _t(rng, e, d, f) * 0.1,
         "w_up": _t(rng, e, d, f) * 0.1, "w_down": _t(rng, e, f, d) * 0.1}
    x = _t(rng, 8, 4, d)
    y_ref, aux_ref = moe.moe_apply(p, x, cfg, groups=2)
    xs = _place(x, [Shard(0), Shard(0), Replicate()], mesh)
    rules = sh.activation_rules(mesh, sh.ShardingPolicy(), global_batch=8)
    with implicit_replication(), layers.activation_sharding(rules):
        y, aux = moe.moe_apply(p, xs, cfg, groups=2)
    out["moe"] = {"y": _max_diff(y.full_tensor(), y_ref),
                  "aux": abs(float(aux.full_tensor()) - float(aux_ref)),
                  "x_placements": [str(q) for q in xs.placements]}


def split_cell(out: dict) -> None:
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(2)
    x = _t(rng, 4, 3, 60)
    xs = _place(x, [Replicate(), Shard(2)], mesh)
    seen = []

    def heads(row):
        y = layers.split_dim(row, -1, 15, 4)
        if layers.placements_of(y) is not None:
            seen.append([str(q) for q in layers.placements_of(y)])
        return torch.sum(y * torch.arange(4.0), dim=-1)

    with implicit_replication():
        y = torch.func.vmap(heads)(xs)
    ref = torch.func.vmap(heads)(x)
    out["split"] = {"y": _max_diff(y.full_tensor(), ref),
                    "placements": seen[0], "shape": list(y.shape)}


result: dict = {}
decode_cells(result)
moe_cell(result)
split_cell(result)
if rank == 0:
    print("RESULT::" + json.dumps(result))

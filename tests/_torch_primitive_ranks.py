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
    DTensor whose 60-wide dim is split over 2 ranks and cut into 15 heads;
  * ``rows_<case>``: attention (``attention._sdpa``, causal, GQA) with q,
    k and v split along the sequence over "data" (the per-example rules)
    and by heads or not at all over "model": the output and the q, k and
    v gradients against ``_attend``'s on plain tensors, by autograd and
    under ``torch.func.vmap`` of ``grad`` (the per-example path), and the
    gradients' placements;
  * ``shift_<n>_<split>``: ``placement.shift_rows`` by n rows of a
    DTensor split along the sequence (and along its width), and its
    gradient; ``conv_<split>``: Mamba's causal conv on a sequence- or
    width-split input; ``mamba``: ``ssm.mamba_apply`` (smoke Jamba) on a
    sequence split over "data": each against the plain call;
  * ``residual_<case>``: ``placement.add_residual`` of a row-parallel FFN
    output, a MoE output and a pending sum beside a split stream: the
    placements it ends in and the values against the plain add.
"""

import json

from repro_torch.launch.ranks import init_rank

rank, world = init_rank("gloo")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor,
    Partial,
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
from repro_torch.models import attention, layers, moe, ssm  # noqa: E402
from repro_torch.models.placement import (  # noqa: E402
    add_residual,
    placements_of,
    shift_rows,
)


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


def _names(x) -> list:
    return [str(q) for q in placements_of(x)]


def rows_cells(out: dict) -> None:
    """Attention with q's rows split along the sequence over "data"."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 8, 4, 8
    mask = attention._causal_mask(s, s)

    def loss(qq, kk, vv, ww):
        return (attention._sdpa(qq, kk, vv, mask) * ww).sum()

    # (KV heads, q's placements, the keys'): heads split with the KV heads
    # or, under one KV head, picked out of whole keys on each "model" rank
    cases = {"seq": (2, [Shard(1), Replicate()], [Shard(1), Replicate()]),
             "seq_heads": (2, [Shard(1), Shard(2)], [Shard(1), Shard(2)]),
             "seq_one_kv_head": (1, [Shard(1), Shard(2)],
                                 [Shard(1), Replicate()])}
    for name, (kvh, pq, pk) in cases.items():
        q, k, v = _t(rng, b, s, h, d), _t(rng, b, s, kvh, d), \
            _t(rng, b, s, kvh, d)
        w = _t(rng, b, s, h, d)
        ref = attention._attend(q, k, v, mask)[0]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (attention._attend(*leaves, mask)[0] * w).sum().backward()
        ref_grads = [t.grad for t in leaves]
        ref_vmap = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
            *(t[:, None] for t in (q, k, v, w)))
        with implicit_replication():
            qs = _place(q, pq, mesh).requires_grad_()
            ks, vs = (_place(t, pk, mesh).requires_grad_() for t in (k, v))
            y = attention._sdpa(qs, ks, vs, mask)
            (y * _place(w, pq, mesh)).sum().backward()
            got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
                *(_place(t[:, None], [Shard(2), pl[1]], mesh)
                  for t, pl in ((q, pq), (k, pk), (v, pk), (w, pq))))
        out[f"rows_{name}"] = {
            "y": _max_diff(y.full_tensor(), ref),
            "y_placements": _names(y),
            "grads": [_max_diff(t.grad.full_tensor(), r)
                      for t, r in zip((qs, ks, vs), ref_grads)],
            "grad_placements": [_names(t.grad) for t in (qs, ks, vs)],
            "vmap_grads": [_max_diff(g.full_tensor(), r)
                           for g, r in zip(got, ref_vmap)],
        }


def shift_cells(out: dict) -> None:
    """``shift_rows``, Mamba's causal conv and ``mamba_apply`` on split
    sequences and widths, against the plain calls."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(4)
    x, dy = _t(rng, 2, 8, 6), _t(rng, 2, 8, 6)
    splits = {"seq": [Shard(1), Replicate()],
              "seq_width": [Shard(1), Shard(2)],
              "batch_seq": [Shard(0), Shard(1)]}
    for n in (1, 3):
        leaf = x.clone().requires_grad_()
        ref = shift_rows(leaf, n)
        ref.backward(dy)
        for name, pl in splits.items():
            with implicit_replication():
                xs = _place(x, pl, mesh).requires_grad_()
                y = shift_rows(xs, n)
                y.backward(_place(dy, pl, mesh))
            out[f"shift_{n}_{name}"] = {
                "y": _max_diff(y.full_tensor(), ref),
                "grad": _max_diff(xs.grad.full_tensor(), leaf.grad),
                "placements": _names(y)}
    cfg = get_smoke_config("jamba-v0.1-52b")
    g = torch.Generator().manual_seed(5)
    p = ssm.mamba_init(cfg, torch.float32, g)
    di = cfg.mamba_expand * cfg.d_model
    xi = _t(rng, 2, 8, di)
    ref = ssm._causal_conv(xi, p["conv_w"], p["conv_b"])
    for name, (px, pw, pb) in {
            "seq": ([Shard(1), Replicate()], [Replicate()] * 2,
                    [Replicate()] * 2),
            "width": ([Replicate(), Shard(2)], [Replicate(), Shard(1)],
                      [Replicate(), Shard(0)])}.items():
        with implicit_replication():
            y = ssm._causal_conv(_place(xi, px, mesh),
                                 _place(p["conv_w"], pw, mesh),
                                 _place(p["conv_b"], pb, mesh))
        out[f"conv_{name}"] = {"y": _max_diff(y.full_tensor(), ref),
                               "placements": _names(y)}
    x = _t(rng, 2, 8, cfg.d_model)
    with torch.no_grad():
        ref = ssm.mamba_apply(p, x, cfg)
        with implicit_replication():
            y = ssm.mamba_apply(p, _place(x, [Shard(1), Replicate()], mesh),
                                cfg)
    out["mamba"] = {"y": _max_diff(y.full_tensor(), ref),
                    "placements": _names(y)}


def _pending(t, mesh, placements):
    """``t`` as a DTensor pending a sum over the mesh dims ``placements``
    marks ``Partial`` (rank 0 of each holds ``t``, the others zeros, so
    that the sum is ``t`` bit for bit), split as it says elsewhere."""
    keep = [Replicate() if q.is_partial() else q for q in placements]
    local = _place(t, keep, mesh).to_local()
    coord = mesh.get_coordinate()
    if any(c for c, q in zip(coord, placements) if q.is_partial()):
        local = torch.zeros_like(local)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def residual_cells(out: dict) -> None:
    """``add_residual`` of branch outputs pending a sum."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rng = np.random.default_rng(6)
    cfg = get_smoke_config("smollm-360m")
    d, f = cfg.d_model, cfg.d_ff
    x = _t(rng, 4, 6, d)
    p = {"w_gate": _t(rng, d, f) * 0.1, "w_up": _t(rng, d, f) * 0.1,
         "w_down": _t(rng, f, d) * 0.1}
    ref = x + layers.ffn_apply(p, x, cfg.ffn_kind)
    ps = {"w_gate": _place(p["w_gate"], [Replicate(), Shard(1)], mesh),
          "w_up": _place(p["w_up"], [Replicate(), Shard(1)], mesh),
          "w_down": _place(p["w_down"], [Replicate(), Shard(0)], mesh)}
    xs = _place(x, [Shard(0), Replicate()], mesh)
    with implicit_replication():
        h = layers.ffn_apply(ps, xs, cfg.ffn_kind)
        y = add_residual(xs, h)
    out["residual_ffn"] = {"h": _names(h), "y": _names(y),
                           "diff": _max_diff(y.full_tensor(), ref)}
    mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    mcfg = get_smoke_config("qwen3-moe-30b-a3b")
    e, fe, dm = mcfg.n_experts, mcfg.expert_d_ff, mcfg.d_model
    mp = {"w_router": _t(rng, dm, e), "w_gate": _t(rng, e, dm, fe) * 0.1,
          "w_up": _t(rng, e, dm, fe) * 0.1, "w_down": _t(rng, e, fe, dm) * 0.1}
    xm = _t(rng, 8, 4, dm)
    ref = xm + moe.moe_apply(mp, xm, mcfg, groups=2)[0]
    xs = _place(xm, [Shard(0), Shard(0), Replicate()], mesh3)
    rules = sh.activation_rules(mesh3, sh.ShardingPolicy(), global_batch=8)
    with implicit_replication(), layers.activation_sharding(rules):
        h = moe.moe_apply(mp, xs, mcfg, groups=2)[0]
        y = add_residual(xs, h)
    out["residual_moe"] = {"x": _names(xs), "y": _names(y),
                           "diff": _max_diff(y.full_tensor(), ref)}
    # the decode's stream: split by width over "data", pending over
    # "model" (the attention's wo); the branch pending over "data"
    hx = _t(rng, 4, 1, d)
    xs = _pending(x[:, :1], mesh, [Shard(2), Partial()])
    hs = _pending(hx, mesh, [Partial(), Shard(0)])
    with implicit_replication():
        y = add_residual(xs, hs)
    out["residual_pending"] = {"y": _names(y),
                               "diff": _max_diff(y.full_tensor(),
                                                 x[:, :1] + hx)}


result: dict = {}
decode_cells(result)
moe_cell(result)
split_cell(result)
rows_cells(result)
shift_cells(result)
residual_cells(result)
if rank == 0:
    print("RESULT::" + json.dumps(result))

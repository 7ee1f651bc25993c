"""Logical-axis -> mesh sharding rules, and their DTensor placements.

Counterpart of ``repro.launch.sharding``.  Every rule is the reference's,
unchanged, and returns its ``PartitionSpec`` as data: a tuple with one
entry per tensor dim, each ``None``, a mesh-axis name or a tuple of
names.  ``to_placements(spec, mesh)`` turns such a spec into DTensor
placements on a ``DeviceMesh``, and ``place(t, spec, mesh)`` makes the
DTensor from a tensor every rank holds whole (no communication).

Param specs are derived from the axis names encoded in the reference's
parameter keys (``models.layers.logical_axes``).  The port keeps its own
short names, so ``param_specs`` walks a transformer's parameters on the
reference's tree (``convert``'s layout, for the flat ``layers`` stack and
the ``group{gi}/e{j}`` nesting alike) and returns the specs in the port's
layout, leaf for leaf.  Policy, as in the reference:

  * tensor parallel ("model"): mlp, qheads, kv_heads, vocab, inner (Mamba),
    experts (expert parallelism);
  * FSDP ("data", optionally +"pod"): the embed dim of every weight;
  * anything non-divisible falls back to replication (e.g. smollm's 15
    heads stay replicated while its flattened 960-wide q projection shards).

A mesh here is anything with ``mesh_dim_names`` and ``size(dim)``: a
``DeviceMesh``, or ``launch.mesh.AbstractMesh`` where only the shape
matters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.layers import logical_axes

Spec = tuple  # one entry per dim: None | axis name | tuple of names


def _spec(entries) -> Spec:
    """A spec from per-dim entries, a one-axis tuple spelled as its name
    (as ``PartitionSpec`` normalises it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True            # shard embed dim over data axes
    fsdp_over_pod: bool = False  # include "pod" in the FSDP axes
    tp: bool = True              # shard mlp/heads/vocab/experts over model
    shard_experts: bool = True
    batch_over_pod: bool = True
    # For archs whose head count cannot shard over "model" (smollm's 15
    # heads): reshard the attention batch over (data, model) instead of
    # replicating the quadratic attention work on every model rank.
    attn_batch_over_model: bool = False


def extent(mesh, axis: str) -> int:
    """The size of ``mesh``'s axis named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _axis_rules(mesh, policy: ShardingPolicy) -> dict[str, Any]:
    names = mesh.mesh_dim_names
    has_pod = "pod" in names
    data_axes: tuple[str, ...] = tuple(
        a for a in (("pod",) if (has_pod and policy.batch_over_pod) else ())
    ) + ("data",)
    fsdp_axes = (("pod", "data") if (has_pod and policy.fsdp_over_pod)
                 else ("data",)) if policy.fsdp else None
    model = "model" if policy.tp else None
    return {
        "batch": data_axes,
        "embed": fsdp_axes,
        "mlp": model,
        "qheads": model,
        "kv_heads": model,
        "heads": model,
        "vocab": model,
        "experts": model if policy.shard_experts else None,
        "expert_mlp": None,
        "inner": model,
        "dc": None,
        "rope": None,
        "state": None,
        "conv": None,
        "layers": None,
        "kv_seq": ("data",),
        None: None,
    }


def _mesh_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(extent(mesh, a) for a in axis)
    return extent(mesh, axis)


def spec_for_leaf(key: str, shape: tuple[int, ...], mesh, rules: dict
                  ) -> Spec:
    axes = logical_axes(key, len(shape))
    entries = []
    used: set = set()
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax)
        flat = tuple(mesh_ax) if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if (
            mesh_ax is None
            or dim % _mesh_size(mesh, mesh_ax) != 0
            or any(a in used for a in flat)
        ):
            entries.append(None)
        else:
            entries.append(mesh_ax)
            used.update(flat)
    return _spec(entries)


def _map_keyed(tree, fn, key: str = ""):
    """``fn(key, leaf)`` over a dict/list tree; ``key`` is the leaf's own
    dict key ("" under a list), as the reference's path walk reads it."""
    if isinstance(tree, dict):
        return {k: _map_keyed(v, fn, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_keyed(v, fn, "") for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(key, tree)


def spec_leaves(tree, sort: bool = False) -> list:
    """A dict tree's leaves in its key order, or sorted by key as JAX
    flattens a dict (a spec tuple is one leaf)."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort else list(tree)
        return [x for k in keys for x in spec_leaves(tree[k], sort)]
    return [tree]


def _is_transformer(params) -> bool:
    return isinstance(params, dict) and isinstance(params.get("embed"),
                                                   torch.Tensor)


def reference_tree(tree: dict) -> dict:
    """A transformer's tree in the port's layout (parameters, or their
    specs) as the reference's tree, leaves unchanged."""
    from repro_torch import convert

    return convert._to_layout(tree, lambda t: t, head="head" in tree,
                              flat="layers" in tree)


def param_specs(params, mesh, policy: ShardingPolicy):
    """A spec per leaf of ``params``, in ``params``' own layout (works on
    meta tensors too): a transformer's keys are read on the reference's
    tree, any other tree's (the tabular models') on its own."""
    rules = _axis_rules(mesh, policy)

    def one(key, leaf):
        return spec_for_leaf(key, tuple(leaf.shape), mesh, rules)

    if not _is_transformer(params):
        return _map_keyed(params, one)
    by_id: dict[int, Spec] = {}
    _map_keyed(reference_tree(params),
               lambda k, leaf: by_id.setdefault(id(leaf), one(k, leaf)))
    return _map_keyed(params, lambda _, leaf: by_id[id(leaf)])


def activation_rules(mesh, policy: ShardingPolicy, *, global_batch: int,
                     shard_kv_seq: bool = False,
                     per_example: bool = False) -> dict:
    """Rules consumed by ``models.layers.shard`` during forward.

    per_example=True is the DP microbatch path: the (tiny) per-example batch
    dim stays unsharded and the *sequence* shards over data instead.
    """
    rules = _axis_rules(mesh, policy)
    batch_axes = rules["batch"]
    seq_axes = None
    if per_example or global_batch % _mesh_size(mesh, batch_axes) != 0:
        batch_axes = None  # e.g. long_500k batch=1 -> shard KV seq instead
        seq_axes = ("data",)
    attn_batch = batch_axes
    if policy.attn_batch_over_model and batch_axes is not None:
        flat = tuple(batch_axes) if isinstance(batch_axes, tuple) \
            else (batch_axes,)
        cand = flat + ("model",)
        if global_batch % _mesh_size(mesh, cand) == 0:
            attn_batch = cand
    return {
        "__mesh__": mesh,
        "batch": batch_axes,
        "attn_batch": attn_batch,
        "seq": seq_axes,
        "mlp": rules["mlp"],
        "heads": rules["heads"],
        "vocab": rules["vocab"],
        "experts": rules["experts"],
        "kv_seq": ("data",) if shard_kv_seq else None,
    }


def batch_specs(batch, mesh, policy: ShardingPolicy):
    """Shard every batch leaf's leading (example) axis over the data axes."""
    batch_axes = _axis_rules(mesh, policy)["batch"]

    def one(_, leaf):
        if leaf.ndim == 0:
            return ()
        if leaf.shape[0] % _mesh_size(mesh, batch_axes) == 0:
            return _spec((batch_axes,) + (None,) * (leaf.ndim - 1))
        return (None,) * leaf.ndim

    return _map_keyed(batch, one)


def cache_specs(cache, mesh, policy: ShardingPolicy, *, global_batch: int):
    """KV-cache sharding: batch over data when divisible; otherwise the cache
    *sequence* shards over data (long_500k)."""
    batch_axes = _axis_rules(mesh, policy)["batch"]
    batch_ok = global_batch % _mesh_size(mesh, batch_axes) == 0
    model_ok = policy.tp
    bax = batch_axes if batch_ok else None

    def over_model(n):
        return "model" if model_ok and n % extent(mesh, "model") == 0 \
            else None

    def one(key, leaf):
        lead = (None,)  # stacked caches carry a leading layers dim
        shape = tuple(leaf.shape[1:])
        if key in ("k", "v", "c", "kr"):  # [B, L, KV, hd] / [B, L, d]
            spec = [None] * len(shape)
            if batch_ok:
                spec[0] = batch_axes
            elif shape[1] % extent(mesh, "data") == 0:
                spec[1] = ("data",)
            if key in ("k", "v"):
                spec[2] = over_model(shape[2])
            return _spec(lead + tuple(spec))
        if key == "conv":                 # [B, K, DI]
            return _spec(lead + (bax, None, over_model(shape[2])))
        if key == "ssm":                  # [B, DI, DS]
            return _spec(lead + (bax, over_model(shape[1]), None))
        if key == "x_prev":               # [B, 1, D]
            return _spec(lead + (bax, None, None))
        if key == "wkv":                  # [B, NH, HS, HS]
            return _spec(lead + (bax, over_model(shape[1]), None, None))
        return (None,) * leaf.ndim

    return _map_keyed(cache, one)


def opt_state_specs(opt_name: str, params, pspecs, opt_state, mesh):
    """Optimizer-state specs derived from the param specs.

    adamw mu/nu mirror the params; adafactor vr drops the last param axis and
    vc drops the second-to-last; counts are replicated.  Where two leaves
    share a shape the first in the reference's leaf order (its tree,
    sorted keys) gives the spec, as there.
    """
    if _is_transformer(params):
        params, pspecs = reference_tree(params), reference_tree(pspecs)
    shape_to_spec: dict[tuple, Spec] = {}
    for p, s in zip(spec_leaves(params, sort=True),
                    spec_leaves(pspecs, sort=True)):
        shape_to_spec.setdefault(tuple(p.shape), s)
        if len(p.shape) >= 2:
            shape_to_spec.setdefault(tuple(p.shape[:-1]), s[:-1])
            shape_to_spec.setdefault(tuple(p.shape[:-2] + p.shape[-1:]),
                                     s[:-2] + s[-1:])

    def one(_, leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        spec = shape_to_spec.get(tuple(leaf.shape))
        return (None,) * leaf.ndim if spec is None else spec

    return _map_keyed(opt_state, one)


def replicated(mesh) -> Spec:
    return ()


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(dim)`` on each
    mesh dim a tensor dim names (a tuple, in its order), ``Replicate()``
    on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            placements[names.index(axis)] = Shard(dim)
    return placements


def is_replicated(spec: Spec) -> bool:
    return all(e is None for e in spec)


def local_slice(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view; DTensor's even
    ``Shard`` split, each tensor dim cut by its mesh axes in order)."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            md = names.index(axis)
            t = t.chunk(mesh.size(md), dim=dim)[coord[md]]
    return t


def place(t: torch.Tensor, spec: Spec, mesh):
    """``t`` (held whole by every rank, or a meta tensor) as a DTensor on
    ``mesh`` under ``spec``, each rank keeping its own block: no
    communication."""
    from torch.distributed.tensor import DTensor

    local = local_slice(t, spec, mesh)
    if local.device.type != "meta":
        local = local.contiguous()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())

"""Multi-pod dry run: place every (arch x shape) program on the production
mesh and trace it once, allocating nothing.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each program for 512 placeholder devices and reads XLA's cost analysis.
Here a ``fake`` process group of the mesh's size stands in for the ranks
(``launch.mesh.init_fake_group``: collectives are recorded, nothing is
sent), ``launch.steps.build_program`` gives the program's arguments as
meta tensors, ``launch.sharding``'s specs place them as DTensors (params,
optimizer state, batch, KV cache), and the program runs once on this
rank's meta shards under the reference's activation rules.  A dispatch
mode below DTensor counts what this rank executes: FLOPs by op (the
formulas of ``torch.utils.flop_counter``, on local shapes) and
collectives by kind, with their bytes (the larger of a collective's
input and output on this rank).  Each rank's argument bytes are summed
from its local shards.

Per-rank counts are scaled to the whole mesh as the reference scales its
per-device HLO (x n_chips: replicated work is counted on every rank), and
``launch.roofline.roofline_terms`` applies the H100's constants with the
argument bytes (each read once) as the memory term's traffic: a lower
bound, where the reference's HLO model counts every buffer.  The
reference's HLO-only fields (``dot_bytes``, ``dus_bytes``,
``toplevel_result_bytes``, ``compile_s``, the HLO cache) have no
counterpart.  Records go to ``build/dryrun_torch/`` (never
``benchmarks/``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro_torch.configs.shapes import ShapeSkip
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import init_fake_group, make_production_mesh
from repro_torch.launch.roofline import model_flops, roofline_terms
from repro_torch.launch.steps import build_program
from repro_torch.models.layers import activation_sharding

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun_torch")
_SKIP = {torch.ops.aten.is_contiguous.default,
         torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.is_strides_like_format.default,
         torch.ops.aten.is_non_overlapping_and_dense.default,
         torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default, torch.ops.prim.layout.default}


_COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
                "broadcast")
_META_LIB = None


def _meta_equal() -> None:
    """Give ``aten::equal`` a Meta kernel in this process (once): DTensor
    compares the mask buffers of its ``MaskPartial`` placements (vocab-
    sharded embeddings and gathers), and a meta tensor has no values to
    compare.  Every comparison is answered "equal", which changes what
    is traced not at all: only shapes flow."""
    global _META_LIB
    if _META_LIB is None:
        _META_LIB = torch.library.Library("aten", "IMPL")
        _META_LIB.impl("equal", lambda a, b: a.shape == b.shape, "Meta")


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(x) for x in obj)
    return 0


class RankCounts(TorchDispatchMode):
    """This rank's work: DTensor ops are let through (``NotImplemented``)
    so DTensor runs them and their local ops come back here, where FLOPs
    are counted as ``FlopCounterMode`` counts them and the functional
    collectives by kind and bytes."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: Counter = Counter()
        self.coll_bytes: Counter = Counter()
        self.coll_counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        # DTensor's own ops run first (their local ops come back here)
        if func in _SKIP or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers shapes on fake
            # tensors: no work of the rank's
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[str(packet)] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        kind = str(packet).split(".")[-1]
        if "c10d" in str(packet) and kind.startswith(_COLLECTIVES):
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += max(_nbytes(args[0]), _nbytes(out))
        return out


def _place_tree(tree, specs, mesh):
    if isinstance(tree, torch.Tensor):
        return sh.place(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_place_tree(v, s, mesh) for v, s in zip(tree, specs)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def _local_bytes(tree) -> int:
    if hasattr(tree, "to_local"):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _placed_program(cfg, shape_name: str, mesh, policy, dp_mode):
    """The program, its placed arguments and its activation rules."""
    shape = INPUT_SHAPES[shape_name]
    b = shape["global_batch"]
    names = mesh.mesh_dim_names
    data = mesh.size(names.index("data"))
    data_size = math.prod(mesh.size(names.index(a))
                          for a in ("pod", "data") if a in names)
    kind = shape["kind"]
    groups = data if kind != "decode" or b % data == 0 else 1
    program = build_program(cfg, shape_name, "meta", dp_mode=dp_mode,
                            moe_groups=groups)
    if kind == "train":
        params, opt_state, batch = program.args
        pspecs = sh.param_specs(params, mesh, policy)
        ospecs = sh.opt_state_specs(program.cfg.optimizer, params, pspecs,
                                    opt_state, mesh)
        args = (_place_tree(params, pspecs, mesh),
                _place_tree(opt_state, ospecs, mesh),
                _place_tree(batch, sh.batch_specs(batch, mesh, policy), mesh),
                None)
        micro = program.meta["microbatch"]
        rules = sh.activation_rules(
            mesh, policy, global_batch=b,
            per_example=(program.meta["dp_mode"] == "per_example"
                         and micro % data_size != 0))
    elif kind == "prefill":
        params, batch = program.args
        args = (_place_tree(params, sh.param_specs(params, mesh, policy),
                            mesh),
                _place_tree(batch, sh.batch_specs(batch, mesh, policy), mesh))
        rules = sh.activation_rules(mesh, policy, global_batch=b)
    else:
        params, cache, tokens, index = program.args
        tok = sh.batch_specs({"tokens": tokens}, mesh, policy)["tokens"]
        args = (_place_tree(params, sh.param_specs(params, mesh, policy),
                            mesh),
                _place_tree(cache, sh.cache_specs(cache, mesh, policy,
                                                  global_batch=b), mesh),
                sh.place(tokens, tok, mesh), shape["seq_len"] - 1)
        rules = sh.activation_rules(mesh, policy, global_batch=b,
                                    shard_kv_seq=(b % data != 0))
    return program, args, rules


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh=None, dp_mode: str | None = None, policy=None,
            out_dir: str | None = None, tag: str = "",
            cfg_overrides: dict | None = None) -> dict:
    """Place and trace one (arch, shape, mesh) and write its record.

    Without ``mesh``, joins a ``fake`` group of the production mesh's size
    and builds it; a given mesh must be a ``DeviceMesh`` on the "cpu"
    device type over the current group."""
    from torch.distributed.tensor.experimental import implicit_replication

    _meta_equal()
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if mesh is None:
        init_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    policy = policy or sh.ShardingPolicy()
    name = mesh_name(mesh)
    n_chips = mesh.size()
    t0 = time.time()
    program, args, rules = _placed_program(cfg, shape_name, mesh, policy,
                                           dp_mode)
    t_place = time.time() - t0
    counts = RankCounts()
    with implicit_replication(), activation_sharding(rules), counts:
        program.fn(*args)
    t_trace = time.time() - t0 - t_place

    flops_rank = float(sum(counts.flops.values()))
    coll_rank = float(sum(counts.coll_bytes.values()))
    arg_rank = float(_local_bytes(args))
    flops = flops_rank * n_chips
    coll = coll_rank * n_chips
    mf = model_flops(program.cfg, INPUT_SHAPES[shape_name], program.kind)
    terms = roofline_terms(flops=flops, hbm_bytes=arg_rank * n_chips,
                           coll_bytes=coll, n_chips=n_chips)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "axis_names": list(mesh.mesh_dim_names),
        "n_chips": n_chips,
        "kind": program.kind,
        "meta": program.meta,
        "place_s": t_place,
        "trace_s": t_trace,
        "model_flops": mf,
        "useful_flops_ratio": mf / flops if flops else None,
        "flops": flops,
        "flops_per_rank": flops_rank,
        "flops_by_op_per_rank": dict(counts.flops.most_common()),
        "collective_bytes": coll,
        "collective_bytes_per_rank": coll_rank,
        "collective_by_kind": {k: v * n_chips
                               for k, v in counts.coll_bytes.items()},
        "collective_counts_per_rank": dict(counts.coll_counts),
        "argument_bytes_per_rank": arg_rank,
        "roofline": terms,
        "tag": tag,
    }
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    print(f"[{arch} x {shape_name} x {name}] OK place={t_place:.1f}s "
          f"trace={t_trace:.1f}s flops={flops:.3e} coll={coll:.3e}B "
          f"bottleneck={terms['bottleneck']}", flush=True)
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=list(ARCHITECTURES), default=None)
    p.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape) on the selected mesh")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--dp-mode", default=None,
                   choices=["per_example", "ghost", "none"])
    p.add_argument("--tag", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    init_fake_group(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    if args.all:
        combos = [(a, s) for a in ARCHITECTURES for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    failures, skips = [], []
    for arch, shape in combos:
        suffix = f"__{args.tag}" if args.tag else ""
        path = os.path.join(args.out or ARTIFACT_DIR,
                            f"{arch}__{shape}__{mesh_name(mesh)}{suffix}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[{arch} x {shape}] exists, skipping")
            continue
        try:
            run_one(arch, shape, mesh=mesh, dp_mode=args.dp_mode,
                    out_dir=args.out, tag=args.tag)
        except ShapeSkip as e:
            print(f"[{arch} x {shape}] SKIP: {e}")
            skips.append((arch, shape, str(e)))
        except Exception as e:
            print(f"[{arch} x {shape}] FAIL: {type(e).__name__}: {e}")
            traceback.print_exc(limit=8)
            failures.append((arch, shape, f"{type(e).__name__}: {e}"))
    print(f"\ndone: {len(combos) - len(failures) - len(skips)} ok, "
          f"{len(skips)} skipped, {len(failures)} failed")
    if failures:
        for f_ in failures:
            print("  FAIL:", f_)
        raise SystemExit(1)


if __name__ == "__main__":
    main()

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
``benchmarks/``), each with its op log beside it
(``<record>.ops.jsonl.gz``: every distinct local op this rank ran, with
its argument and output shapes and dtypes and how many times it ran,
and each collective's kind and bytes), which ``launch.reanalyze``
re-scores without tracing again, as the reference re-reads the HLO it
caches beside each record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh 2,2,2
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import sys
import time
import traceback
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro_torch.configs.shapes import ShapeSkip
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (
    MULTI_POD_AXES,
    init_fake_group,
    make_mesh,
    make_production_mesh,
)
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
# ops that read a tensor's values, answered on meta tensors as if nothing
# were selected, where DTensor's own code asks (``_answered_read``)
_READS_VALUES = {
    torch.ops.aten._local_scalar_dense.default:
        lambda t: False if t.dtype == torch.bool else 0,
    torch.ops.aten.nonzero.default:
        lambda t: torch.empty((0, t.dim()), dtype=torch.long, device="meta"),
}
_META_LIB = None
_DTENSOR_CODE = os.path.join("torch", "distributed", "tensor", "")
# the frames between an op's caller and a dispatch mode
_DISPATCH_FRAMES = tuple(os.path.join("torch", *p) for p in (
    ("_dynamo", ""), ("_compile.py",), ("utils", "_python_dispatch.py")))


def _answered_read(func, args) -> bool:
    """Whether ``func`` reads the values of a meta tensor for DTensor's
    own code, whose local op it is (torch 2.11 masks a vocab shard with a
    boolean write, which reads a count; the answer changes no shape of
    the masked write).  A read anywhere else, also one of a DTensor the
    model reads, is not answered: it raises, as on any meta tensor, where
    an invented value would steer a branch."""
    if func not in _READS_VALUES or not args[0].is_meta:
        return False
    frame = sys._getframe(2)
    while frame is not None and any(
            p in frame.f_code.co_filename for p in _DISPATCH_FRAMES):
        frame = frame.f_back
    where = frame.f_code.co_filename if frame is not None else ""
    return _DTENSOR_CODE in where and \
        not where.endswith(os.path.join("tensor", "_dispatch.py"))


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


def _squeeze_dims_rule() -> None:
    """Give DTensor a rule for ``aten.squeeze.dims`` where it has none
    (torch 2.11; 2.13 has one): ``vmap``'s backward of a broadcast
    squeezes a tuple of dims.  The rule is a view's, as DTensor's own
    for ``squeeze.dim``: the dims of size 1 named go, the rest stay."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops as views

    op = torch.ops.aten.squeeze.dims
    if op in DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs:
        return

    def squeeze_dims(x, dims):
        gone = {d % x.ndim for d in dims}
        return tuple(views.InputDim(i) for i, n in enumerate(x.shape)
                     if n != 1 or i not in gone)

    views.dim_maps[squeeze_dims] = squeeze_dims
    views.register_op_strategy_map(op, squeeze_dims,
                                   schema_info=RuntimeSchemaInfo(1))


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(x) for x in obj)
    return 0


def _spec(x):
    """An op argument as the op log keeps it: a tensor's [shape, dtype], a
    list of such, or None for anything else."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
    if isinstance(x, (list, tuple)) and any(isinstance(t, torch.Tensor)
                                            for t in x):
        return tuple(_spec(t) for t in x)
    return None


class RankCounts(TorchDispatchMode):
    """This rank's work: DTensor ops are let through (``NotImplemented``)
    so DTensor runs them and their local ops come back here, where FLOPs
    are counted as ``FlopCounterMode`` counts them and the functional
    collectives by kind and bytes.  ``ops`` is the op log: how many times
    each distinct (op, positional argument specs, output specs) ran, and a
    collective's kind and bytes (``write_op_log``)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: Counter = Counter()
        self.coll_bytes: Counter = Counter()
        self.coll_counts: Counter = Counter()
        self.ops: Counter = Counter()
        self.answered: Counter = Counter()     # value reads answered
        self.scale = 1

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Count everything within n times (a loop's identical bodies,
        traced once: ``core.dp.per_example_clipped_grad_sum``'s
        ``trace_repeat``)."""
        self.scale *= n
        try:
            yield
        finally:
            self.scale //= n

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
        if _answered_read(func, args):
            self.answered[str(func)] += 1
            return _READS_VALUES[func](args[0])
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[str(packet)] += self.scale * flop_registry[packet](
                *args, **kwargs, out_val=out)
        kind = str(packet).split(".")[-1]
        coll = None
        if "c10d" in str(packet) and kind.startswith(_COLLECTIVES):
            coll = (kind, max(_nbytes(args[0]), _nbytes(out)))
            self.coll_counts[kind] += self.scale
            self.coll_bytes[kind] += self.scale * coll[1]
        self.ops[(str(func), tuple(_spec(a) for a in args), _spec(out),
                  coll)] += self.scale
        return out


def op_log_path(json_path: str) -> str:
    """The op log beside a record: ``<record>.ops.jsonl.gz``."""
    return json_path[:-len(".json")] + ".ops.jsonl.gz"


def write_op_log(ops: Counter, path: str) -> None:
    """One JSON line per distinct op: ``op``, ``args`` (each positional
    argument's [shape, dtype], a list of them, or null), ``out`` and
    ``n``, the times it ran; a collective adds ``kind`` and ``bytes``.
    gzip-compressed (the standard library's)."""
    with gzip.open(path, "wt") as f:
        for (op, args, out, coll), n in ops.items():
            line = {"op": op, "args": args, "out": out, "n": n}
            if coll is not None:
                line["kind"], line["bytes"] = coll
            f.write(json.dumps(line) + "\n")


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


def _placed_program(cfg, shape_name: str, mesh, policy, dp_mode,
                    trace_repeat=None):
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
                            moe_groups=groups, trace_repeat=trace_repeat)
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
    _squeeze_dims_rule()
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
    counts = RankCounts()
    # a per-example program's microbatches are traced once, counted n times
    program, args, rules = _placed_program(cfg, shape_name, mesh, policy,
                                           dp_mode, counts.repeated)
    t_place = time.time() - t0
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
        # value reads of meta tensors answered for DTensor's masking
        "value_reads_answered": dict(counts.answered),
        "roofline": terms,
        "tag": tag,
        "cfg_overrides": cfg_overrides or {},
    }
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    write_op_log(counts.ops, op_log_path(path))
    print(f"[{arch} x {shape_name} x {name}] OK place={t_place:.1f}s "
          f"trace={t_trace:.1f}s flops={flops:.3e} coll={coll:.3e}B "
          f"bottleneck={terms['bottleneck']}", flush=True)
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=list(ARCHITECTURES), default=None)
    p.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="another mesh than the production one: 'D,M' "
                        "(\"data\", \"model\") or 'P,D,M' (\"pod\", "
                        "\"data\", \"model\"), e.g. 4,2 or 2,2,2")
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape) on the selected mesh")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--dp-mode", default=None,
                   choices=["per_example", "ghost", "none"])
    p.add_argument("--tag", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    if args.mesh:
        dims = tuple(int(n) for n in args.mesh.split(","))
        if len(dims) not in (2, 3) or args.multi_pod:
            p.error("--mesh takes 2 or 3 extents, without --multi-pod")
        init_fake_group(math.prod(dims))
        mesh = make_mesh(dims, MULTI_POD_AXES[-len(dims):], "cpu")
    else:
        init_fake_group(512 if args.multi_pod else 256)
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
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

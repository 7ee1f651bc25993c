"""The ``shard`` backend: SPMD execution of the fused cohort round-step.

Counterpart of ``repro.launch.federated``.  Every rank of a
``torch.distributed`` group runs the same ``arms.run(..., backend="shard",
mesh=mesh)``: the same host ``np.random.Generator`` draws the whole
cohort on every rank (the reference's Poisson draws, number for number),
each rank computes its part of the fused cohort step, and every rank ends
with the same ``RunReport``.  ``ShardedRunner`` defaults to a 1-D
``("data",)`` mesh (``launch.mesh.make_host_data_mesh``) and accepts the
``("pod", "data", "model")`` meshes of ``make_production_mesh`` /
``make_debug_mesh``.  The placement rules are the reference's:

  * on a mesh with a pod axis, the *participant* axis splits over
    ("pod", "data") whenever the cohort size divides pod·data.  Each rank
    runs its own slots through the arm's cohort step, noise share
    included (drawn by absolute participant index, so it is ``ideal``'s
    share); the per-slot trees are then all-gathered and every rank folds
    them in ascending slot order — bit for bit the ``ideal`` backend.  The
    participant axis is never padded: a padded slot would add a phantom
    noise share;
  * otherwise the *example* axis splits over the data axes: the cohort pad
    is rounded up to the data extent (masks keep pad rows inert) and each
    rank computes its rows of every slot.  A slot's clipped sum and its
    masked loss sum are all-reduced (``fused.example_sum``) *before* the
    slot's noise share is added, once: adding shares per rank would
    multiply the noise variance by the data extent.  Ghost clipping needs
    only each example's own rows, so per-example norms stay local;
  * on a mesh with a ``model`` axis, model-parallel parameters become
    DTensors on the model sub-mesh by ``launch.sharding.param_specs`` with
    ``ShardingPolicy(fsdp=False, tp=True)`` and the cohort step runs on
    them (DTensor's propagation; the ``ghost_norm`` kernel runs on local
    shards, ``kernels.ghost_norm.ops``).  Tabular leaves encode no axes
    and stay replicated (``param_shards == 0``);
  * outputs come back whole and replicated, so the arm's ``aggregate`` is
    ``ideal``'s code.

The explicit collectives go through ``Communicator``: NCCL where each rank
has its own card, ``gloo`` where the ranks share one card or run on the
CPU.  The caller chooses the group's backend and the run prints it;
where ``gloo`` holds CUDA tensors the communicator stages each collective
through host memory, explicitly, and counts those bytes.  DTensor's own
collectives (the functional ``_c10d_functional`` ops) crash under
``gloo`` on CUDA tensors, so a run with a model axis over ``gloo`` on the
card stages them through host memory too (``stage_functional_collectives``,
installed once per process and printed), with their bytes and seconds
counted by kind.  Partitioned sums
re-associate float math, so ``shard`` sits in its own ``bit_exact_group``
("spmd"): against ``ideal`` it agrees within 1e-5, bit for bit where the
participant axis splits and no model axis exists.

Capability record: fused-only (no per-participant loop to fall back to)
and no SecAgg (payloads never leave the device on this path).
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.arms import fused
from repro_torch.arms.backends import (
    BackendInfo,
    RunSetup,
    compatibility_error,
    register_backend,
)
from repro_torch.arms.runners import LocalRunner
from repro_torch.launch.mesh import data_axes, make_host_data_mesh
from repro_torch.models.layers import activation_sharding
from repro_torch.launch.sharding import (
    ShardingPolicy,
    is_replicated,
    param_specs,
    place,
    spec_leaves,
)

_DEVICE_HINT = (
    "needs a torch.distributed process group of >= 2 ranks: start them "
    "with torchrun, or init_process_group('gloo', ...) in spawned "
    "processes where the ranks share one card or run on the CPU"
)


def _is_dtensor(x) -> bool:
    return hasattr(x, "placements") and hasattr(x, "to_local")


def _map(fn, obj):
    """``fn`` over every tensor in nested dicts, lists and tuples (named
    too); anything else is kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_map(fn, v) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else type(obj)(items)
    return obj


def _leaves(obj) -> list[torch.Tensor]:
    out: list = []
    _map(out.append, obj)
    return out


def _rebuild(obj, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), obj)


def _groups_over(mesh, axes: tuple[str, ...]):
    """The process group over ``axes`` of ``mesh`` holding this rank (every
    rank creates every such group, in the same order, as
    ``dist.new_group`` requires) and this rank's index in it."""
    import torch.distributed as dist

    grid = mesh.mesh
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(grid.ndim) if d not in dims]
    rows = grid.permute(rest + dims).reshape(-1, math.prod(
        grid.shape[d] for d in dims))
    me = dist.get_rank()
    mine = None
    for row in rows.tolist():
        g = dist.new_group(row)
        if me in row:
            mine = (g, row.index(me))
    return mine


class Communicator:
    """The backend's explicit collectives over one process group, counted
    by kind: bytes and seconds per rank.  Where the group's backend is
    ``gloo`` and a tensor lies on the card, each collective is staged
    through host memory (``staged_bytes``), since ``gloo`` runs on the
    CPU."""

    def __init__(self, group, size: int, rank: int) -> None:
        import torch.distributed as dist

        self.group, self.size, self.rank = group, size, rank
        self.backend = dist.get_backend(group)
        self.bytes: dict[str, int] = defaultdict(int)
        self.seconds: dict[str, float] = defaultdict(float)
        self.staged_bytes = 0

    @contextlib.contextmanager
    def _counted(self, kind: str, nbytes: int):
        t0 = time.perf_counter()
        yield
        self.seconds[kind] += time.perf_counter() - t0
        self.bytes[kind] += nbytes

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        if self.backend == "gloo" and t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of ``flat`` over the group (a new tensor)."""
        import torch.distributed as dist

        with self._counted("all_reduce", flat.numel() * flat.element_size()):
            buf = self._stage(flat).clone()
            dist.all_reduce(buf, group=self.group)
            return buf.to(flat.device)

    def all_gather(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``flat`` (equal sizes), in group-rank order; this
        rank's entry is ``flat`` itself."""
        import torch.distributed as dist

        with self._counted("all_gather",
                           flat.numel() * flat.element_size() * self.size):
            src = self._stage(flat).contiguous()
            out = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(out, src, group=self.group)
            return [flat if r == self.rank else o.to(flat.device)
                    for r, o in enumerate(out)]


_STAGED: dict | None = None
_FUNCTIONAL = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")


def stage_functional_collectives() -> dict:
    """Run DTensor's functional collectives on CUDA tensors through host
    memory: each op's CUDA kernel becomes a copy to the host, the op's
    CPU (``gloo``) version, its wait and a copy back.  For ranks that
    share one card over ``gloo``; installed once per process.  Returns
    {"bytes": {op: n}, "seconds": {op: s}, "calls": {op: n}}, this
    process's running counts."""
    global _STAGED
    if _STAGED is not None:
        return _STAGED["stats"]
    ops = torch.ops._c10d_functional
    wait = ops.wait_tensor.default
    stats = {"bytes": defaultdict(int), "seconds": defaultdict(float),
             "calls": defaultdict(int)}

    def staged(name):
        op = getattr(ops, name).default

        def run(inp, *args):
            t0 = time.perf_counter()
            host = inp.detach().cpu()
            out = wait(op(host, *args)).to(inp.device)
            stats["bytes"][name] += host.numel() * host.element_size()
            stats["seconds"][name] += time.perf_counter() - t0
            stats["calls"][name] += 1
            return out
        return run

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _FUNCTIONAL:
        lib.impl(name, staged(name), "CUDA")
    reduce_ = staged("all_reduce")
    lib.impl("all_reduce_", lambda inp, *args: inp.copy_(reduce_(inp, *args)),
             "CUDA")
    _STAGED = {"lib": lib, "stats": stats}
    print("shard: DTensor's collectives on CUDA tensors are staged through "
          "host memory (gloo)", flush=True)
    return stats


def staged_stats() -> dict | None:
    """``stage_functional_collectives``' counts, or None where it was never
    installed in this process."""
    return None if _STAGED is None else _STAGED["stats"]


def _pack(leaves: list[torch.Tensor]) -> dict:
    """Leaves packed into one flat buffer per dtype: {dtype: (buffer,
    [(leaf index, numel, shape)])}."""
    groups: dict = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    return {dt: (torch.cat([leaves[i].reshape(-1) for i in idx]),
                 [(i, leaves[i].numel(), leaves[i].shape) for i in idx])
            for dt, idx in groups.items()}


def _unpack(packed: dict, n: int, buffers: dict) -> list[torch.Tensor]:
    out: list = [None] * n
    for dt, (_, layout) in packed.items():
        off = 0
        for i, numel, shape in layout:
            out[i] = buffers[dt][off:off + numel].reshape(shape)
            off += numel
    return out


class MeshExecutor:
    """Runs each fused cohort step on ``mesh`` (installed around every
    round by ``fused.execution_context``).

    ``stack_poisson`` hands it the cohort's stacked arrays (``mark``); the
    arm's cohort step then runs through ``execute`` with model-parallel
    params as DTensors, and through the hooks ``slots`` /
    ``gather_slots`` (participant split), ``example_sum`` (example split)
    and ``pads_slots``.  Counters as the reference's:
    ``sharded_puts`` (placements that split an axis),
    ``participant_shards`` (arrays split over ("pod", "data")),
    ``param_shards`` (param leaves over ("model",)).
    """

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        axes = data_axes(mesh)
        self._pod_mesh = len(axes) > 1  # ("pod","data",...) production shape
        self.data_size = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                                   for a in axes)
        group, rank = _groups_over(mesh, axes)
        self.data = Communicator(group, self.data_size, rank)
        self.model_mesh = None
        self.model = None
        # model-parallel placement: TP only — FSDP would split the embed
        # dim over the same axes that carry hospitals
        self._param_policy = None
        if "model" in mesh.mesh_dim_names:
            self.model_mesh = mesh["model"]
            n_model = self.model_mesh.size()
            group, rank = _groups_over(mesh, ("model",))
            self.model = Communicator(group, n_model, rank)
            self._param_policy = ShardingPolicy(fsdp=False, tp=True)
            # the activation hints' rules on the model sub-mesh: each
            # model group holds its examples whole, the TP axes split
            self._rules = {"__mesh__": self.model_mesh, "batch": None,
                           "attn_batch": None, "seq": None, "kv_seq": None,
                           **{a: "model" for a in ("mlp", "heads", "vocab",
                                                   "experts")}}
        self._marks: dict[int, tuple] = {}
        self._param_marks: dict[int, tuple] = {}
        self._split: str | None = None
        self.sharded_puts = 0
        self.participant_shards = 0
        self.param_shards = 0

    # -- hooks consumed by repro_torch.arms.fused -----------------------------

    def round_pad(self, pad: int) -> int:
        """Round a cohort pad up to a multiple of the data-axis size."""
        return -(-pad // self.data_size) * self.data_size

    def mark(self, arr: np.ndarray, axis: int) -> None:
        """Declare ``arr`` a cohort batch to split.  Pod meshes split the
        participant axis (0) over ("pod", "data") when the cohort size
        divides them; otherwise the example axis ``axis`` splits (never a
        padded participant slot)."""
        if self._pod_mesh and arr.shape[0] % self.data_size == 0:
            self._marks[id(arr)] = (arr, None)
            self._split = "participant"
            self.participant_shards += 1
            return
        if arr.shape[axis] % self.data_size:
            return  # replication fallback (same rule as launch/sharding.py)
        self._marks[id(arr)] = (arr, axis)
        self._split = "example"

    def local_rows(self, arr: np.ndarray) -> np.ndarray:
        """This rank's part of a marked array: its block of the example
        axis, or (participant split) the whole cohort, of which it
        computes its own slots."""
        mark = self._marks.get(id(arr))
        if mark is None:
            return arr
        self.sharded_puts += 1
        if mark[1] is None:
            return arr
        n = arr.shape[mark[1]] // self.data_size
        lo = self.data.rank * n
        return np.ascontiguousarray(
            np.take(arr, np.arange(lo, lo + n), axis=mark[1]))

    def slots(self, n: int):
        if self._split != "participant":
            return range(n)
        k = n // self.data_size
        return range(self.data.rank * k, (self.data.rank + 1) * k)

    def gather_slots(self, results: list, n: int) -> list:
        """Every slot's tree in slot order; under the participant split an
        all-gather of each rank's slots, leaf by leaf (exact: bits are only
        moved; a rank's own slots stay its own tensors)."""
        results = [self.whole(r) for r in results]
        if self._split != "participant":
            return results
        k = len(results)
        out: list = [None] * n
        for j, tree in enumerate(results):
            leaves = _leaves(tree)
            got = [self.data.all_gather(t.reshape(-1)) for t in leaves]
            for r in range(self.data_size):
                out[r * k + j] = _rebuild(tree, [
                    g[r].reshape(t.shape) for g, t in zip(got, leaves)])
        return out

    def pads_slots(self) -> bool:
        """Whether the cohort steps hand the clip function each slot's
        padded rows: the example split gives each rank a block of them,
        and on the model axis DTensor's sharding propagation depends on
        the batch's size (torch 2.11 could not split the heads of a
        one-row slot's activations)."""
        return self._split == "example" or self.model is not None

    def example_sum(self, tree):
        """A slot's per-example sums made whole and, under the example
        split, summed over the data ranks."""
        tree = self.whole(tree)
        if self._split != "example":
            return tree
        leaves = _leaves(tree)
        packed = _pack(leaves)
        summed = {dt: self.data.all_reduce(buf)
                  for dt, (buf, _) in packed.items()}
        return _rebuild(tree, _unpack(packed, len(leaves), summed))

    # -- model-parallel params ------------------------------------------------

    def mark_params(self, params) -> None:
        """Declare ``params`` for TP placement over the ``model`` axis; a
        no-op without one.  Leaves whose keys encode no shardable axis
        (every tabular model's) stay plain, replicated tensors."""
        if self._param_policy is None:
            return
        specs = param_specs(params, self.mesh, self._param_policy)
        for leaf, spec in zip(spec_leaves(params), spec_leaves(specs)):
            if not is_replicated(spec):
                self._param_marks[id(leaf)] = (leaf, spec)
                self.param_shards += 1

    def begin_round(self) -> None:
        self._marks.clear()
        self._param_marks.clear()
        self._split = None

    def _place(self, x):
        mark = self._param_marks.get(id(x)) if isinstance(x, torch.Tensor) \
            else None
        if mark is None:
            return x
        return place(x, mark[1], self.model_mesh)

    def execute(self, fn, args, kwargs):
        """``fn`` on this rank's operands: marked params as DTensors on the
        model sub-mesh (plain tensors meet them as replicated), outputs
        made whole."""
        if not self._param_marks:
            return fn(*args, **kwargs)
        from torch.distributed.tensor.experimental import implicit_replication

        if self.model.backend == "gloo" and any(
                leaf.is_cuda for leaf, _ in self._param_marks.values()):
            stage_functional_collectives()
        args, kwargs = _map(self._place, (list(args), kwargs))
        with implicit_replication(), activation_sharding(self._rules):
            out = fn(*args, **kwargs)
        return self.whole(out)

    def whole(self, tree):
        """``tree`` with every DTensor leaf made a whole plain tensor, by
        the model communicator's all-gather (shards) or all-reduce
        (partial sums)."""
        if self.model is None:
            return tree
        return _map(self._whole_leaf, tree)

    def _whole_leaf(self, x):
        if not _is_dtensor(x):
            return x
        (p,) = x.placements
        local = x.to_local()
        if p.is_replicate():
            return local
        if p.is_partial():
            return self.model.all_reduce(local.reshape(-1)).reshape(
                local.shape)
        parts = self.model.all_gather(local.contiguous().reshape(-1))
        return torch.cat([q.reshape(local.shape) for q in parts], dim=p.dim)


@register_backend(BackendInfo(
    name="shard",
    supports_fused=True,
    supports_secagg=False,
    supports_sim_time=False,
    fused_only=True,
    bit_exact_group="spmd",
    device_requirements=_DEVICE_HINT,
    description="SPMD execution of the fused cohort round-step on a device "
                "mesh (example axis sharded over data, params replicated)",
))
class ShardedRunner(LocalRunner):
    """Idealized round schedule, SPMD round numerics: ``LocalRunner``'s
    lockstep loop with its contributions seam run on the mesh."""

    def __init__(self, topo=None, *, mesh=None, on_round=None) -> None:
        super().__init__(topo=topo, on_round=on_round)
        if mesh is None:
            reason = self.available()
            if reason is not None:
                raise RuntimeError(f"backend 'shard' unavailable: {reason}")
            mesh = make_host_data_mesh()
        self.mesh = mesh
        self.executor = MeshExecutor(mesh)

    @classmethod
    def from_setup(cls, setup: RunSetup) -> "ShardedRunner":
        return cls(topo=setup.topo, mesh=setup.mesh, on_round=setup.on_round)

    @classmethod
    def available(cls) -> str | None:
        import torch.distributed as dist

        if (not dist.is_available() or not dist.is_initialized()
                or dist.get_world_size() < 2):
            return _DEVICE_HINT
        return None

    def run(self, arm):
        # belt and braces under direct construction: arms.run already
        # negotiates these pairs — same rules, single source of truth
        err = compatibility_error(
            type(arm), self.info, use_secagg=arm.cfg.use_secagg,
            fused_rounds=arm.cfg.fused_rounds,
        )
        if err is not None:
            raise ValueError(err)
        if self.executor.data.rank == 0 and (
                self.executor.model is None or self.executor.model.rank == 0):
            print(f"shard: mesh {dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}"
                  f" over {self.executor.data.backend}", flush=True)
        return super().run(arm)

    def _contributions(self, arm, params, active, t, rng, payloads):
        ex = self.executor
        ex.begin_round()
        ex.mark_params(params)
        with fused.execution_context(ex):
            out = super()._contributions(arm, params, active, t, rng,
                                         payloads)
        if not (arm.cfg.fused_rounds and arm.fused_capable):
            raise RuntimeError(
                f"arm {arm.name!r} fell back to the per-participant loop "
                "under the fused-only 'shard' backend")
        return out

"""Mesh factories over a ``torch.distributed`` process group.

Counterpart of ``repro.launch.mesh``.  Each factory is a function that
builds a ``DeviceMesh`` over the ranks of the process group this process
has already joined; none touches distributed state at import.  A mesh
needs one process per rank, so each factory raises, naming how to start
the ranks, unless a group of exactly the mesh's size is initialised:

  * on cards: ``torchrun --nproc-per-node N ...`` (NCCL, one card a rank),
    or ranks spawned with ``init_process_group("gloo", ...)`` where the
    ranks share one card (NCCL refuses two ranks on one device);
  * on the CPU: ``gloo`` ranks (the tests' spawn helper);
  * for a dry run of the production meshes: ``init_fake_group(512)``, a
    ``fake`` group whose collectives move nothing (``launch.dryrun``).

Each factory takes the device type explicitly, ``"cuda"`` by default.
Each rank's device is its own card, or the one card when ranks share it.
``AbstractMesh`` stands for a mesh's shape where no ranks exist at all:
the sharding rules read only its axis names and extents.
"""

from __future__ import annotations

import dataclasses
import math

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without ranks or devices (the
    counterpart of ``jax.sharding.AbstractMesh``), read by
    ``launch.sharding``'s rules through ``DeviceMesh``'s own interface."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: int | None = None) -> int:
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]


def _start_hint(n: int) -> str:
    return (f"start {n} ranks first: torchrun --nproc-per-node {n} (NCCL, "
            f"one card a rank), or init_process_group('gloo', "
            f"init_method='file://...', rank=r, world_size={n}) in each "
            f"spawned process (ranks sharing one card, or the CPU); a dry "
            f"run uses launch.mesh.init_fake_group({n})")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    group, which must hold exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"no process group is initialised for a "
                           f"{shape} mesh; {_start_hint(n)}")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks but the process "
                           f"group has {dist.get_world_size()}; "
                           f"{_start_hint(n)}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: (16, 16) ("data", "model") on one pod, (2, 16,
    16) ("pod", "data", "model") multi-pod.  DeCaPH maps hospitals onto
    ("pod", "data"); the ``shard`` backend accepts these meshes directly.
    Only a ``fake`` group (``init_fake_group``) is this large here."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device_type: str = "cuda"):
    """A small mesh of the production axes for tests and one card."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), MULTI_POD_AXES, device_type)
    return make_mesh((n_data, n_model), PRODUCTION_AXES, device_type)


def make_host_data_mesh(n_data: int | None = None,
                        device_type: str = "cuda"):
    """1-D ("data",) mesh over ``n_data`` ranks (default: every rank of the
    group).  The ``shard`` backend splits the fused cohort step's
    *example* axis over it; tabular-scale params stay replicated."""
    import torch.distributed as dist

    if n_data is None:
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("no process group is initialised for a "
                               "('data',) mesh; " + _start_hint(2))
        n_data = dist.get_world_size()
    return make_mesh((n_data,), ("data",), device_type)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the batch/participant dimension."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a == "model")


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Join a ``fake`` process group of ``world_size`` ranks in this one
    process: meshes of any size can be built and DTensor programs traced
    (collectives are recorded, nothing is sent).  For dry runs only."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)

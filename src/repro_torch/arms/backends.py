"""Backend registry + capability-negotiated Runner protocol (DESIGN.md §8).

Counterpart of ``repro.arms.backends``.  A backend is a class satisfying
the ``Runner`` protocol, with a ``BackendInfo`` capability record,
registered by ``register_backend``::

    @register_backend(BackendInfo(name="ideal", ...))
    class LocalRunner:
        @classmethod
        def from_setup(cls, setup: RunSetup) -> "LocalRunner": ...
        def run(self, arm: Arm) -> RunReport: ...

The CLI (``python -m repro_torch.run``) and the tests enumerate
``backend_registry()``.  ``validate_run`` refuses an (arm, backend, config)
combination the record rules out, with the rule that rejected it, before
any compute.  ``bit_exact_group``: backends sharing a group promise
bit-identical trajectories under ideal conditions.

The port registers ``ideal`` and ``sim`` (``arms.runners``), ``shard``
(``launch.federated``: the fused cohort step SPMD over a
``torch.distributed`` mesh) and ``population`` (``population.backend``),
as the reference does.  The backend classes are loaded on first registry
access.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import (TYPE_CHECKING, Any, Callable, Protocol, Sequence,
                    runtime_checkable)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.arms.base import Arm, ArmConfig
    from repro_torch.arms.results import RunReport

# The default execution substrate everywhere a caller does not choose one.
DEFAULT_BACKEND = "ideal"

# Importing one of these modules registers its backend(s).
_BACKEND_MODULES = (
    "repro_torch.arms.runners",       # ideal + sim
    "repro_torch.launch.federated",   # shard (SPMD mesh execution)
    "repro_torch.population.backend",  # population
)


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    """What one execution backend can (and cannot) do.

    Attributes:
      name: registry key (``--backend`` value).
      supports_fused: executes arms' cohort ``fused_round`` programs.
      supports_secagg: runs the SecAgg wire protocol.
      supports_sim_time: consumes node traces, topologies and link churn,
        i.e. produces a ``SimTiming`` systems story.
      fused_only: refuses arms without a fused round (and
        ``fused_rounds=False``): no per-participant loop to fall back to.
      supports_subsampling: honours ``participation_rate < 1``; without it
        every hospital runs every round and a subsampled accountant would
        claim an ε the execution never delivered.
      bit_exact_group: backends sharing a non-empty group promise
        bit-identical trajectories for the same (arm, config) under ideal
        conditions.
      device_requirements: human-readable device needs ("" = none).
    """

    name: str
    supports_fused: bool = True
    supports_secagg: bool = True
    supports_sim_time: bool = False
    fused_only: bool = False
    supports_subsampling: bool = False
    bit_exact_group: str = ""
    device_requirements: str = ""
    description: str = ""


@dataclasses.dataclass
class RunSetup:
    """Backend-agnostic execution context handed to ``Runner.from_setup``;
    each backend consumes what it understands and rejects, at
    construction, what it requires but did not get."""

    nodes: Sequence[Any] | None = None  # HospitalNode list (sim-time backends)
    topo: Any | None = None             # Topology override
    mesh: Any | None = None             # DeviceMesh override (SPMD backends)
    # ``on_round(t, params)`` after every completed round on every backend:
    # the checkpoint-handoff seam (DESIGN.md §9)
    on_round: Callable[[int, Any], None] | None = None


@runtime_checkable
class Runner(Protocol):
    """The backend contract: construct from a ``RunSetup``, execute any arm.
    An optional classmethod ``available() -> str | None`` says why the
    backend cannot run in this process (None = ready)."""

    info: BackendInfo

    @classmethod
    def from_setup(cls, setup: RunSetup) -> "Runner": ...  # pragma: no cover

    def run(self, arm: "Arm") -> "RunReport": ...  # pragma: no cover


_REGISTRY: dict[str, type] = {}


def register_backend(info: BackendInfo) -> Callable[[type], type]:
    """Class decorator: ``@register_backend(BackendInfo(name="sim", ...))``."""

    def deco(cls: type) -> type:
        if info.name in _REGISTRY:
            raise ValueError(
                f"backend {info.name!r} already registered "
                f"({_REGISTRY[info.name].__qualname__})"
            )
        cls.info = info
        cls.backend = info.name  # the RunReport.backend label
        _REGISTRY[info.name] = cls
        return cls

    return deco


def _ensure_loaded() -> None:
    for mod in _BACKEND_MODULES:
        importlib.import_module(mod)


def backend_names() -> tuple[str, ...]:
    """Registered backend names, sorted for stable CLI/CI enumeration."""
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def backend_registry() -> dict[str, BackendInfo]:
    """name -> capability record, for every registered backend."""
    _ensure_loaded()
    return {name: _REGISTRY[name].info for name in sorted(_REGISTRY)}


def get_backend(name: str) -> type:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(backend_names())}"
        ) from None


def availability(name: str) -> str | None:
    """Why backend ``name`` cannot run in this process (None = it can)."""
    check = getattr(get_backend(name), "available", None)
    return check() if check is not None else None


def bit_exact_groups() -> dict[str, tuple[str, ...]]:
    """Equivalence classes of backends that promise bit-identical runs."""
    groups: dict[str, list[str]] = {}
    for name, info in backend_registry().items():
        if info.bit_exact_group:
            groups.setdefault(info.bit_exact_group, []).append(name)
    return {g: tuple(sorted(ns)) for g, ns in sorted(groups.items())}


# -- capability negotiation ---------------------------------------------------


def compatibility_error(arm_cls: type, info: BackendInfo, *,
                        use_secagg: bool, fused_rounds: bool = True,
                        participation_rate: float = 1.0) -> str | None:
    """The rule that rejects this (arm, backend, config) — or None if OK."""
    arm_name = getattr(arm_cls, "name", arm_cls.__name__)
    if participation_rate < 1.0 and not info.supports_subsampling:
        return (
            f"participation_rate={participation_rate} requires Poisson "
            f"cohort subsampling but backend {info.name!r} runs every "
            f"hospital every round; its ε accounting would be wrong "
            f"(use a backend with supports_subsampling)"
        )
    if fused_rounds and not info.supports_fused:
        return (
            f"backend {info.name!r} cannot execute fused cohort programs; "
            f"set fused_rounds=False to run it per-participant"
        )
    secure = bool(getattr(arm_cls, "secure_uploads", False)) and use_secagg
    if secure and not info.supports_secagg:
        return (
            f"arm {arm_name!r} uploads SecAgg ciphertexts but backend "
            f"{info.name!r} does not run the SecAgg wire protocol "
            f"(set use_secagg=False to run it there)"
        )
    if info.fused_only:
        if getattr(arm_cls, "mode", "") != "round" or not getattr(
                arm_cls, "fused_capable", False):
            return (
                f"backend {info.name!r} only executes fused-capable round "
                f"arms; arm {arm_name!r} has no fused cohort round-step"
            )
        if not fused_rounds:
            return (
                f"backend {info.name!r} has no per-participant loop to fall "
                f"back to; fused_rounds=False is not executable there"
            )
    return None


def validate_run(arm_cls: type, info: BackendInfo, cfg: "ArmConfig") -> None:
    """Loud pre-flight check used by ``repro_torch.arms.run``."""
    err = compatibility_error(
        arm_cls, info, use_secagg=cfg.use_secagg,
        fused_rounds=cfg.fused_rounds,
        participation_rate=cfg.participation_rate,
    )
    if err is not None:
        raise ValueError(err)


def validate_scenario(
    *,
    arm: str,
    backend: str,
    use_secagg: bool,
    needs_sim_time: bool,
    participation_rate: float = 1.0,
) -> None:
    """Capability-gate a ``ScenarioSpec`` at construction time.

    Unknown backends are always an error (the backend axis *is* the
    registry); an unknown arm is left for the executor to reject so specs
    can be built before optional arm modules load.
    """
    try:
        info = get_backend(backend).info
    except KeyError:
        raise ValueError(
            f"backend {backend!r} not registered; registered backends: "
            f"{', '.join(backend_names())}"
        ) from None
    if needs_sim_time and not info.supports_sim_time:
        raise ValueError(
            f"spec pins node traces / topology / stragglers but backend "
            f"{backend!r} does not execute simulated time (it would "
            f"silently ignore them); use a backend with supports_sim_time"
        )
    import repro_torch.arms as arms_lib  # deferred: the torch-importing path

    try:
        arm_cls = arms_lib.get(arm)
    except KeyError:
        return  # executor fails loudly on unknown arms (with the arm list)
    err = compatibility_error(
        arm_cls, info, use_secagg=use_secagg,
        participation_rate=participation_rate,
    )
    if err is not None:
        raise ValueError(err)

"""The port's one execution backend and its pre-flight check (DESIGN.md §8).

Counterpart of ``repro.arms.backends``, cut to what the port runs: the
``ideal`` backend (``arms.runners.LocalRunner``), its ``BackendInfo``
record and ``validate_run``, which refuses an (arm, backend, config)
combination the record rules out before any compute.  The reference's
backend registry comes back with a second backend (the simulated-time
``SimRunner``, ROADMAP.md Queue 1 item 5b).

``ideal`` runs SecAgg (``supports_secagg``): an arm with SecAgg uploads
under ``use_secagg=True`` sums its payloads through
``core.secagg.secure_sum`` and its batch sizes through ``secure_sum_ints``.
The rule that refuses secure uploads on a backend without SecAgg stays, as
in the reference, for the backends still to come.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.arms.base import ArmConfig

DEFAULT_BACKEND = "ideal"


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    """What one execution backend can (and cannot) do (the reference's
    ``repro.arms.backends.BackendInfo``, with the fields a ported rule
    reads)."""

    name: str
    supports_secagg: bool = True       # runs the SecAgg wire protocol
    supports_subsampling: bool = False  # honours participation_rate < 1
    description: str = ""


IDEAL = BackendInfo(
    name="ideal",
    supports_secagg=True,
    description="idealized lockstep: every hospital infinitely fast and "
                "always online, communication free",
)


def compatibility_error(arm_cls: type, backend: str, *, use_secagg: bool,
                        participation_rate: float = 1.0) -> str | None:
    """The rule that rejects this (arm, backend, config) — or None if OK."""
    if backend != IDEAL.name:
        return (f"unknown backend {backend!r}; the port runs only "
                f"{IDEAL.name!r} so far (ROADMAP.md, Queue 1 item 5b)")
    arm_name = getattr(arm_cls, "name", arm_cls.__name__)
    if participation_rate < 1.0 and not IDEAL.supports_subsampling:
        return (
            f"participation_rate={participation_rate} requires Poisson "
            f"cohort subsampling but backend {backend!r} runs every "
            f"hospital every round; its ε accounting would be wrong"
        )
    secure = bool(getattr(arm_cls, "secure_uploads", False)) and use_secagg
    if secure and not IDEAL.supports_secagg:
        return (
            f"arm {arm_name!r} uploads SecAgg ciphertexts but backend "
            f"{backend!r} does not run SecAgg; set use_secagg=False to run "
            f"it there"
        )
    return None


def validate_run(arm_cls: type, backend: str, cfg: "ArmConfig") -> None:
    """Loud pre-flight check used by ``repro_torch.arms.run``."""
    err = compatibility_error(arm_cls, backend, use_secagg=cfg.use_secagg,
                              participation_rate=cfg.participation_rate)
    if err is not None:
        raise ValueError(err)

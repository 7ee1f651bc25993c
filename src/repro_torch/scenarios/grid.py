"""``SweepGrid`` — expand axis products into scenario-spec lists.

A grid is a base ``ScenarioSpec`` plus named axes (any spec field -> list of
values); ``specs()`` is the cartesian product, each cell named
``sweep/axis=value,...`` so cache entries and report rows are self-describing.

Counterpart of ``repro.scenarios.grid``: the same named sweeps over the
same bases, so every cell both packages share has the same spec hash.
The arm and backend axes are resolved lazily from the port's live
registries (``repro_torch.arms.names()``, ``backends.backend_names()``)
at expansion time, so a newly registered arm or backend joins every sweep
automatically — and ``backend-matrix`` has no ``shard`` cells, which the
port does not run.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

from repro_torch.scenarios.spec import ScenarioSpec


def _registered_arms() -> tuple[str, ...]:
    # deferred: sweep expansion resolves the (torch-importing) arm registry
    import repro_torch.arms as arms

    return arms.names()


def _registered_backends() -> tuple[str, ...]:
    """The live backend registry — a newly registered backend joins every
    backend axis automatically, exactly like arms join the arm axis."""
    from repro_torch.arms import backends

    return backends.backend_names()


@dataclasses.dataclass
class SweepGrid:
    """Axis product over ScenarioSpec fields."""

    name: str
    base: ScenarioSpec
    axes: Mapping[str, Sequence[Any]]

    def __post_init__(self) -> None:
        fields = {f.name for f in dataclasses.fields(ScenarioSpec)}
        bad = set(self.axes) - fields
        if bad:
            raise ValueError(f"axes over unknown spec fields: {sorted(bad)}")
        for axis, values in self.axes.items():
            if not values:
                raise ValueError(f"axis {axis!r} has no values")

    def size(self) -> int:
        out = 1
        for values in self.axes.values():
            out *= len(values)
        return out

    def specs(self) -> list[ScenarioSpec]:
        keys = sorted(self.axes)
        cells = []
        for combo in itertools.product(*(self.axes[k] for k in keys)):
            assignment = dict(zip(keys, combo))
            label = ",".join(f"{k}={assignment[k]}" for k in keys)
            cells.append(self.base.replace(
                name=f"{self.name}/{label}",
                tags=self.base.tags + ("sweep:" + self.name,),
                **assignment,
            ))
        return cells


# ---------------------------------------------------------------------------
# Named sweeps (factories, so the arm axis reflects the live registry).
# ---------------------------------------------------------------------------


def _tiny_base(name_prefix: str) -> ScenarioSpec:
    """A cell that finishes in ~a second: linear model, small cohort."""
    return ScenarioSpec(
        name=name_prefix, task="gemini", model_size="small", features=8,
        examples=240, rounds=3, batch_size=32, lr=0.4, seed=0,
        backend="sim",
    )


def capacity_mini() -> SweepGrid:
    """Every registered arm x H in {3, 5}, tiny shapes — the resumable
    acceptance sweep (>= 12 cells, seconds per cell)."""
    return SweepGrid(
        "capacity-mini",
        _tiny_base("capacity-mini"),
        {"arm": list(_registered_arms()), "hospitals": [3, 5]},
    )


def capacity() -> SweepGrid:
    """The ROADMAP capacity-planning sweep: every arm x H x bandwidth tier
    x straggler ratio at medium model size (run on demand; hours of sim)."""
    base = ScenarioSpec(
        name="capacity", task="gemini", model_size="medium",
        examples=2400, rounds=12, batch_size=64, lr=0.4, backend="sim",
    )
    return SweepGrid(
        "capacity",
        base,
        {
            "arm": list(_registered_arms()),
            "hospitals": [3, 5, 10, 20],
            "bandwidth": [12.5e6, 1.25e6],       # ~100 / ~10 Mbit/s WAN
            "straggler_ratio": [0.0, 0.3],
        },
    )


def model_scaling() -> SweepGrid:
    """Every arm x model size ladder at fixed H — feeds the bytes-vs-params
    scaling law."""
    base = ScenarioSpec(
        name="model-scaling", task="gemini", model_size="small",
        hospitals=4, examples=960, rounds=4, batch_size=48, lr=0.4,
        backend="sim",
    )
    return SweepGrid(
        "model-scaling",
        base,
        {"arm": list(_registered_arms()), "model_size": ["small", "medium"]},
    )


def smoke_2x2() -> SweepGrid:
    """CI sweep: two arms x two cohort sizes, tiny models (seconds total)."""
    return SweepGrid(
        "smoke-2x2",
        _tiny_base("smoke-2x2").replace(examples=200, rounds=2),
        {"arm": ["decaph", "fedprox"], "hospitals": [3, 4]},
    )


def backend_matrix() -> SweepGrid:
    """Fused round arms x EVERY registered backend, tiny shapes.

    The backend axis is the live registry, so a new backend lands in this
    sweep with zero wiring.  SecAgg is off in the base spec because not
    every backend runs the ciphertext wire protocol — with it on, spec
    validation would (correctly) reject the population cells at expansion
    time.
    """
    return SweepGrid(
        "backend-matrix",
        _tiny_base("backend-matrix").replace(
            examples=200, rounds=2, hospitals=4, use_secagg=False,
        ),
        {"arm": ["decaph", "fl"], "backend": list(_registered_backends())},
    )


def population_scaling() -> SweepGrid:
    """Cross-device scaling: fused arms x H in {50, 200, 1000} x 3 seeds on
    the population backend (k-regular overlay, 10% Poisson participation,
    5% flaky hospitals).  Extends the power-law fits to H=1000 with per-cell
    confidence intervals from the seed axis; the trace phase costs timestamp
    arithmetic only, so the H=1000 cells' host cost is the solve's.
    """
    base = ScenarioSpec(
        name="population-scaling", task="gemini", model_size="small",
        features=16, examples=6000, rounds=5, batch_size=64, lr=0.4,
        hospitals=50,  # >= degree+1 so the base spec itself validates
        backend="population", use_secagg=False, participation_rate=0.1,
        population={
            "topology": "k_regular", "degree": 8,
            "throughput_median": 400.0, "throughput_sigma": 0.5,
            "flaky_fraction": 0.05, "mean_uptime": 120.0,
            "mean_downtime": 15.0,
        },
    )
    return SweepGrid(
        "population-scaling",
        base,
        {
            "arm": ["decaph", "fl"],
            "hospitals": [50, 200, 1000],
            "seed": [0, 1, 2],
        },
    )


def capacity_lm() -> SweepGrid:
    """The transformer capacity column (DESIGN.md §12): decaph over the
    "lm" model-size ladder, ghost vs faithful per-example clipping, on the
    idealized backend: the ghost cells reach the ``ghost_norm`` kernel on
    the card, the per-example cells never do.  This sweep carries the
    utility-vs-ε side of the capacity column.
    """
    base = ScenarioSpec(
        name="capacity-lm", task="lm", model_size="small",
        hospitals=4, examples=96, rounds=4, batch_size=16, lr=0.1,
        backend="ideal", use_secagg=False, microbatch_size=8,
    )
    return SweepGrid(
        "capacity-lm",
        base,
        {
            "model_size": ["small", "medium", "full"],
            "clipping": ["ghost", "per-example"],
        },
    )


SWEEPS: dict[str, Callable[[], SweepGrid]] = {
    "capacity-mini": capacity_mini,
    "capacity": capacity,
    "capacity-lm": capacity_lm,
    "model-scaling": model_scaling,
    "smoke-2x2": smoke_2x2,
    "backend-matrix": backend_matrix,
    "population-scaling": population_scaling,
}


def get_sweep(name: str) -> SweepGrid:
    try:
        return SWEEPS[name]()
    except KeyError:
        raise KeyError(
            f"unknown sweep {name!r}; available: {', '.join(sorted(SWEEPS))}"
        ) from None

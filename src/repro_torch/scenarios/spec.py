"""``ScenarioSpec`` — one declarative, JSON-serialisable experiment cell.

A spec pins everything a run's outcome depends on: the case-study task and
cohort shape, the federation arm and backend, the node traces (compute +
availability), the topology (including time-varying link churn via the
``schedule`` key), the DP configuration, the model preset and the seed.
``repro_torch.scenarios.executor.run_spec`` turns a spec into metrics; the
sweep cache addresses results by ``spec_hash``.

The cache-key contract (DESIGN.md §6): the hash covers every field that can
change the run's numerics or systems metrics, and ONLY those — ``name`` and
``tags`` are labels, excluded from the hash, so renaming a cell or re-tagging
a sweep never invalidates cached results.

Counterpart of ``repro.scenarios.spec``: the same fields, the same
validation messages and the same ``spec_hash()`` for every spec, so a
cell names the same experiment in both packages.  The device is not a
field: it is a run-time argument of the executor (``run_spec(spec,
device=...)``), so it never enters the hash.

This module imports only the stdlib at module level, as do ``cache``,
``grid`` and ``report``.  Validation, however, is registry-backed
(DESIGN.md §8): the ``backend`` field is checked against the live backend
registry and the (arm, backend, secagg/trace) combination is
capability-negotiated, both via a deferred import of
``repro_torch.arms.backends`` — which loads torch at the first spec
construction, not at import.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from repro_torch.canon import content_hash

TASKS = ("gemini", "pancreas", "xray", "lm")
MODEL_SIZES = ("small", "medium", "full")
CLIPPING_MODES = ("auto", "ghost", "per-example")

# bump when the semantics of a field change so stale entries never alias
SPEC_SCHEMA = 3  # v3: the "lm" task + the clipping field joined the key

# label-only fields, excluded from the cache key
_UNHASHED_FIELDS = ("name", "tags")


@dataclasses.dataclass
class ScenarioSpec:
    """Everything one experiment cell depends on, JSON-serialisable."""

    name: str = ""
    task: str = "gemini"            # gemini | pancreas | xray
    arm: str = "decaph"             # any repro_torch.arms registry name
    backend: str = "sim"            # any repro_torch.arms.backends name
    hospitals: int = 5
    model_size: str = "small"       # small | medium | full
    rounds: int = 12
    batch_size: int = 64
    lr: float = 0.4
    seed: int = 0
    examples: int = 1200            # total examples across the cohort
    features: int | None = None     # None -> task/model_size default
    # privacy
    clip_norm: float = 1.0
    noise_multiplier: float = 0.8
    microbatch_size: int = 8
    epsilon_budget: float | None = None
    use_secagg: bool = True
    # per-example clipping path (DESIGN.md §12): "auto" takes the ghost path
    # exactly when the model declares the capability (dense decoder stacks)
    clipping: str = "auto"
    # arm knobs (ignored by arms that do not use them)
    fl_local_steps: int = 1
    fedprox_mu: float = 0.1
    # cross-device (population backend): Poisson cohort subsampling rate q
    participation_rate: float = 1.0
    # systems: explicit traces win over the derived defaults below
    nodes: list[dict] | None = None      # per-hospital trace dicts
    topology: dict | None = None         # Topology.from_trace dict (+schedule)
    # distributional population (PopulationSpec overrides minus hospitals/
    # seed, which this spec owns); mutually exclusive with nodes/topology
    population: dict | None = None
    # derived-trace knobs (used only when nodes/topology are None)
    bandwidth: float = 12.5e6            # bytes/s default link
    latency: float = 0.02                # seconds default link
    throughput: float = 400.0            # examples/s per hospital
    straggler_ratio: float = 0.0         # fraction of hospitals 8x slower
    tags: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self.tags = tuple(self.tags)
        self.validate()

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        if self.task not in TASKS:
            raise ValueError(f"task {self.task!r} not in {TASKS}")
        # deferred import: registry-backed backend + capability validation
        from repro_torch.arms import backends as backends_lib

        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError("participation_rate must be in (0, 1]")
        if self.population is not None:
            if self.nodes is not None or self.topology is not None:
                raise ValueError(
                    "population is mutually exclusive with explicit nodes/"
                    "topology traces (it *generates* them)"
                )
            owned = {"hospitals", "seed"} & set(self.population)
            if owned:
                raise ValueError(
                    f"population may not set {sorted(owned)} — the scenario "
                    f"spec's hospitals/seed fields own those"
                )
            # fail here, not mid-sweep: PopulationSpec re-validates the
            # merged dict including this spec's hospitals count
            from repro_torch.population.spec import PopulationSpec

            PopulationSpec.from_dict(
                {"hospitals": max(self.hospitals, 2), "seed": self.seed,
                 **self.population}
            )
        backends_lib.validate_scenario(
            arm=self.arm, backend=self.backend, use_secagg=self.use_secagg,
            needs_sim_time=(self.nodes is not None
                            or self.topology is not None
                            or self.population is not None
                            or self.straggler_ratio > 0),
            participation_rate=self.participation_rate,
        )
        if self.model_size not in MODEL_SIZES:
            raise ValueError(
                f"model_size {self.model_size!r} not in {MODEL_SIZES}"
            )
        if self.clipping not in CLIPPING_MODES:
            raise ValueError(
                f"clipping {self.clipping!r} not in {CLIPPING_MODES}"
            )
        if not self.arm or not isinstance(self.arm, str):
            raise ValueError("arm must be a non-empty registry name")
        for field, lo in (("hospitals", 1), ("rounds", 1), ("batch_size", 1),
                          ("examples", 1), ("microbatch_size", 1)):
            if getattr(self, field) < lo:
                raise ValueError(f"{field} must be >= {lo}")
        for field in ("lr", "clip_norm", "noise_multiplier", "bandwidth",
                      "latency", "throughput", "straggler_ratio"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")
        if not 0.0 <= self.straggler_ratio <= 1.0:
            raise ValueError("straggler_ratio must be in [0, 1]")
        if self.nodes is not None and len(self.nodes) != self.hospitals:
            raise ValueError(
                f"nodes trace has {len(self.nodes)} entries for "
                f"hospitals={self.hospitals}"
            )
        if self.features is not None and self.features < 1:
            raise ValueError("features must be >= 1")

    # -- (de)serialisation ----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["tags"] = list(self.tags)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScenarioSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ScenarioSpec fields: {sorted(unknown)}")
        return cls(**dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))

    def replace(self, **changes: Any) -> "ScenarioSpec":
        return dataclasses.replace(self, **changes)

    # -- cache key -------------------------------------------------------------

    def hash_material(self) -> dict[str, Any]:
        """The exact dict the cache key is computed over (DESIGN.md §6)."""
        d = self.to_dict()
        for field in _UNHASHED_FIELDS:
            d.pop(field)
        d["_schema"] = SPEC_SCHEMA
        return d

    def spec_hash(self) -> str:
        return content_hash(self.hash_material(), chars=20)

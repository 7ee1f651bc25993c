"""``PopulationSpec`` — generate 1000-hospital federations from distributions.

Cross-silo scenarios pin every hospital's trace by hand; at H=1000 nobody
writes 1000 dicts.  A ``PopulationSpec`` describes the *population* —
per-hospital throughput and availability distributions, a sparse topology
family, link churn — and deterministically materialises the same
JSON-serialisable node/topology traces the rest of the repo already
consumes (``sim.nodes_from_trace`` / ``sim.Topology.from_trace``).  The
same seed always yields byte-identical traces, which is what makes the
trace phase's determinism contract (DESIGN.md §10) hold end to end.

Counterpart of ``repro.population.spec``, the same draws from the same
``random.Random`` streams: ``build_nodes()`` and ``build_topology()`` are
the reference's dicts, value for value.  Stdlib only: building a
population loads no torch, and ``ScenarioSpec.population`` validation
imports this module at spec-construction time.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Mapping

TOPOLOGIES = ("k_regular", "small_world", "star", "ring", "full")

# Fixed sub-stream tags so node sampling, availability sampling and churn
# sampling each consume an independent deterministic stream — adding one
# never perturbs the others.
_TAG_NODES = 101
_TAG_AVAIL = 211
_TAG_CHURN = 307


@dataclasses.dataclass
class PopulationSpec:
    """Distributional description of one hospital population."""

    hospitals: int = 1000
    seed: int = 0
    # -- topology ------------------------------------------------------------
    topology: str = "k_regular"     # k_regular | small_world | star | ring | full
    degree: int = 8                 # k_regular / small_world neighbour count
    rewire_p: float = 0.1           # small_world rewiring probability
    bandwidth: float = 12.5e6       # bytes/s per link
    latency: float = 0.02           # seconds per link
    # -- per-hospital compute (lognormal throughput spread) ------------------
    throughput_median: float = 400.0   # examples/s at the distribution median
    throughput_sigma: float = 0.5      # lognormal sigma (log-space); 0 = uniform
    overhead: float = 0.02             # fixed seconds per round
    # -- availability: a flaky fraction with exponential on/off windows ------
    flaky_fraction: float = 0.05
    mean_uptime: float = 120.0         # seconds online between outages
    mean_downtime: float = 15.0        # seconds per outage
    horizon: float = 3600.0            # availability/churn sampled over [0, horizon)
    # -- link churn ----------------------------------------------------------
    churn_rate: float = 0.0            # expected link outages per sim-second
    churn_downtime: float = 5.0        # seconds a churned link stays down

    def __post_init__(self) -> None:
        self.validate()

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        if self.hospitals < 2:
            raise ValueError("population needs at least 2 hospitals")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"topology {self.topology!r} not in {TOPOLOGIES}"
            )
        if self.topology in ("k_regular", "small_world"):
            if not 2 <= self.degree < self.hospitals:
                raise ValueError(
                    f"degree must satisfy 2 <= k < H "
                    f"(got k={self.degree}, H={self.hospitals})"
                )
        if not 0.0 <= self.rewire_p <= 1.0:
            raise ValueError("rewire_p must be in [0, 1]")
        if not 0.0 <= self.flaky_fraction <= 1.0:
            raise ValueError("flaky_fraction must be in [0, 1]")
        for field in ("bandwidth", "latency", "throughput_median",
                      "throughput_sigma", "overhead", "mean_uptime",
                      "mean_downtime", "horizon", "churn_rate",
                      "churn_downtime"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")
        if self.bandwidth == 0 or self.throughput_median == 0:
            raise ValueError("bandwidth and throughput_median must be > 0")

    # -- (de)serialisation ----------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PopulationSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown PopulationSpec fields: {sorted(unknown)}"
            )
        return cls(**dict(d))

    def replace(self, **changes: Any) -> "PopulationSpec":
        return dataclasses.replace(self, **changes)

    # -- trace materialisation ------------------------------------------------

    def build_nodes(self) -> list[dict]:
        """Per-hospital trace dicts (``sim.nodes_from_trace`` input).

        Throughputs are lognormal around ``throughput_median``; the first
        ``round(flaky_fraction * H)`` hospitals (by a seeded shuffle, so the
        flaky set is not index-correlated with the throughput draw) carry
        exponential on/off availability windows over ``[0, horizon)``.
        """
        h = self.hospitals
        rng = random.Random(f"{self.seed}:{_TAG_NODES}")
        traces: list[dict] = []
        for _ in range(h):
            if self.throughput_sigma > 0:
                thr = self.throughput_median * math.exp(
                    self.throughput_sigma * rng.gauss(0.0, 1.0)
                )
            else:
                thr = self.throughput_median
            traces.append({"throughput": round(thr, 6),
                           "overhead": self.overhead})
        n_flaky = int(round(self.flaky_fraction * h))
        if n_flaky and self.horizon > 0:
            avail = random.Random(f"{self.seed}:{_TAG_AVAIL}")
            flaky = avail.sample(range(h), n_flaky)
            for i in sorted(flaky):
                windows = []
                t = avail.expovariate(1.0 / max(self.mean_uptime, 1e-9))
                while t < self.horizon:
                    down = avail.expovariate(
                        1.0 / max(self.mean_downtime, 1e-9)
                    )
                    windows.append([round(t, 6), round(t + down, 6)])
                    t += down + avail.expovariate(
                        1.0 / max(self.mean_uptime, 1e-9)
                    )
                if windows:
                    traces[i]["dropouts"] = windows
        return traces

    def build_topology(self) -> dict:
        """``sim.Topology.from_trace`` dict (sparse family + churn schedule).

        Churn is a Poisson process over the whole edge set: each event picks
        one edge uniformly, downs it, and restores it ``churn_downtime``
        later — consumable by the existing ``LinkSchedule`` machinery.
        """
        trace: dict[str, Any] = {
            "n": self.hospitals,
            "kind": self.topology,
            "default": {"bandwidth": self.bandwidth,
                        "latency": self.latency},
        }
        if self.topology in ("k_regular", "small_world"):
            trace["k"] = self.degree
        if self.topology == "small_world":
            trace["p"] = self.rewire_p
            trace["seed"] = self.seed
        if self.churn_rate > 0 and self.horizon > 0:
            churn = random.Random(f"{self.seed}:{_TAG_CHURN}")
            edges = self._edge_list()
            schedule = []
            t = churn.expovariate(self.churn_rate)
            while t < self.horizon:
                i, j = edges[churn.randrange(len(edges))]
                schedule.append({"t": round(t, 6), "link": f"{i}-{j}",
                                 "down": True})
                schedule.append({"t": round(t + self.churn_downtime, 6),
                                 "link": f"{i}-{j}",
                                 "bandwidth": self.bandwidth,
                                 "latency": self.latency})
                t += churn.expovariate(self.churn_rate)
            if schedule:
                trace["schedule"] = sorted(schedule, key=lambda e: e["t"])
        return trace

    def _edge_list(self) -> list[tuple[int, int]]:
        """Undirected edge list of the base (pre-churn) topology."""
        # deferred: sim.topology is host Python too, but avoid a module-level
        # cycle (topology never imports population)
        from repro_torch.sim.topology import Topology

        topo = Topology.from_trace(self.build_topology_static())
        return sorted(
            {(min(i, j), max(i, j)) for (i, j) in topo._links}
        )

    def build_topology_static(self) -> dict:
        """The topology dict without the churn schedule."""
        trace = dataclasses.replace(self, churn_rate=0.0).build_topology()
        trace.pop("schedule", None)
        return trace

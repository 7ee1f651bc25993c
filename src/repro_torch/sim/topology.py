"""Network topology: pairwise link bandwidth/latency between hospitals.

The port's copy of ``repro.sim.topology`` (host Python; the small-world
rewiring draws from the same stdlib ``random`` stream).

Links are directed internally (stored per ordered pair) but all builders
create symmetric graphs.  ``transfer_time`` is the latency + serialisation
model ``lat + nbytes / bw`` — intentionally simple; contention-free links
match the cross-silo setting (hospitals talk over independent WAN paths,
not a shared fabric).

Builders cover the paper-relevant shapes:

  * ``full``      — every pair connected (DeCaPH's rotating leader can be
                    anyone, so the mesh must be complete);
  * ``star``      — all traffic through a hub (classic server-based FL);
  * ``ring``      — minimal gossip graph;
  * ``k_regular`` — circulant k-regular gossip graph (each node talks to
                    its k nearest ring neighbours), the standard D-PSGD
                    communication graph;
  * ``small_world`` — Watts-Strogatz rewiring of the circulant graph:
                    keeps ~k edges per node but adds long-range shortcuts,
                    so the hop diameter drops from O(n/k) to O(log n) —
                    the realistic sparse overlay for 1000-node federations.

Topologies may carry a ``LinkSchedule`` — timestamped link changes (degrade,
remove, restore) that model WAN churn.  The schedule is applied lazily:
``advance_to(t)`` folds in every change with time <= t, and the sim backend
calls it whenever the simulated clock moves before consulting a link.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Link:
    bandwidth: float  # bytes per simulated second
    latency: float = 0.0  # seconds

    def __post_init__(self) -> None:
        if self.bandwidth <= 0:
            raise ValueError("bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError("latency must be >= 0")


_DEFAULT_LINK = Link(bandwidth=12.5e6, latency=0.02)  # ~100 Mbit/s WAN


@dataclasses.dataclass(frozen=True)
class LinkChange:
    """One scheduled link event: at ``time``, edge i<->j becomes ``link``
    (both directions), or is removed entirely when ``link`` is None."""

    time: float
    i: int
    j: int
    link: Link | None

    def __post_init__(self) -> None:
        if self.time < 0:
            raise ValueError("change time must be >= 0")
        if self.i == self.j:
            raise ValueError(f"self-edge ({self.i}, {self.j})")


class LinkSchedule:
    """Time-ordered link churn: bandwidth/latency changes and edge removals.

    JSON form (one entry per change; ``down`` removes the edge, an entry
    with a bandwidth re-adds or re-rates it; ``latency`` defaults to 0.0,
    matching the ``links`` override convention of ``Topology.from_trace``)::

        [{"t": 2.0, "link": "0-4", "bandwidth": 1.25e5, "latency": 0.4},
         {"t": 3.5, "link": "0-4", "down": true},
         {"t": 9.0, "link": "0-4", "bandwidth": 1.25e6, "latency": 0.08}]
    """

    def __init__(self, changes: Iterable[LinkChange]):
        self.changes: tuple[LinkChange, ...] = tuple(
            sorted(changes, key=lambda c: c.time)
        )

    def __len__(self) -> int:
        return len(self.changes)

    @classmethod
    def from_trace(cls, entries: Sequence[Mapping]) -> "LinkSchedule":
        changes = []
        for e in entries:
            i, j = (int(x) for x in str(e["link"]).split("-"))
            if e.get("down"):
                link = None
            else:
                link = Link(float(e["bandwidth"]), float(e.get("latency", 0.0)))
            changes.append(LinkChange(float(e["t"]), i, j, link))
        return cls(changes)

    def to_trace(self) -> list[dict]:
        out = []
        for c in self.changes:
            entry: dict = {"t": c.time, "link": f"{c.i}-{c.j}"}
            if c.link is None:
                entry["down"] = True
            else:
                entry["bandwidth"] = c.link.bandwidth
                entry["latency"] = c.link.latency
            out.append(entry)
        return out


def _validate_schedule(schedule: LinkSchedule, n: int) -> None:
    for c in schedule.changes:
        if not (0 <= c.i < n and 0 <= c.j < n):
            raise ValueError(
                f"schedule change on edge ({c.i}, {c.j}) for n={n}"
            )


class Topology:
    """Pairwise links over ``n`` hospitals (optionally time-varying)."""

    def __init__(
        self,
        n: int,
        links: Mapping[tuple[int, int], Link],
        *,
        name: str = "custom",
        schedule: LinkSchedule | None = None,
    ):
        if n < 1:
            raise ValueError("need at least one node")
        self.n = n
        self.name = name
        self._links: dict[tuple[int, int], Link] = {}
        for (i, j), link in links.items():
            if not (0 <= i < n and 0 <= j < n) or i == j:
                raise ValueError(f"bad edge ({i}, {j}) for n={n}")
            self._links[(i, j)] = link
        self.schedule = schedule
        self._applied = 0  # index of the next unapplied schedule change
        if schedule is not None:
            _validate_schedule(schedule, n)

    def advance_to(self, t: float) -> int:
        """Apply every scheduled change with time <= ``t``; returns how many
        fired.  Idempotent and monotonic — the sim clock never rewinds."""
        if self.schedule is None:
            return 0
        fired = 0
        while (
            self._applied < len(self.schedule.changes)
            and self.schedule.changes[self._applied].time <= t
        ):
            c = self.schedule.changes[self._applied]
            if c.link is None:
                self._links.pop((c.i, c.j), None)
                self._links.pop((c.j, c.i), None)
            else:
                self._links[(c.i, c.j)] = c.link
                self._links[(c.j, c.i)] = c.link
            self._applied += 1
            fired += 1
        return fired

    def has_edge(self, i: int, j: int) -> bool:
        return (i, j) in self._links

    def neighbors(self, i: int) -> list[int]:
        return sorted(j for (a, j) in self._links if a == i)

    def link(self, i: int, j: int) -> Link:
        try:
            return self._links[(i, j)]
        except KeyError:
            raise ValueError(
                f"no {self.name} link {i} -> {j}; route through a neighbour"
            ) from None

    def transfer_time(self, i: int, j: int, nbytes: float) -> float:
        """Seconds to move ``nbytes`` over the direct i -> j link."""
        link = self.link(i, j)
        return link.latency + nbytes / link.bandwidth

    def degree(self, i: int) -> int:
        return len(self.neighbors(i))

    # -- builders -----------------------------------------------------------

    @classmethod
    def _symmetric(
        cls, n: int, edges: Iterable[tuple[int, int]], link: Link, name: str
    ) -> "Topology":
        links: dict[tuple[int, int], Link] = {}
        for i, j in edges:
            links[(i, j)] = link
            links[(j, i)] = link
        return cls(n, links, name=name)

    @classmethod
    def full(cls, n: int, link: Link = _DEFAULT_LINK) -> "Topology":
        return cls._symmetric(
            n, ((i, j) for i in range(n) for j in range(i + 1, n)), link,
            "full",
        )

    @classmethod
    def star(cls, n: int, center: int = 0, link: Link = _DEFAULT_LINK) -> "Topology":
        return cls._symmetric(
            n, ((center, j) for j in range(n) if j != center), link, "star"
        )

    @classmethod
    def ring(cls, n: int, link: Link = _DEFAULT_LINK) -> "Topology":
        if n < 3:
            return cls.full(n, link)
        return cls._symmetric(
            n, ((i, (i + 1) % n) for i in range(n)), link, "ring"
        )

    @classmethod
    def k_regular(cls, n: int, k: int, link: Link = _DEFAULT_LINK) -> "Topology":
        """Circulant graph: node i connects to i±1 .. i±(k//2) (mod n);
        odd k on even n adds the antipodal edge i <-> i + n/2."""
        if not 2 <= k < n:
            raise ValueError(f"need 2 <= k < n, got k={k}, n={n}")
        if k % 2 == 1 and n % 2 == 1:
            raise ValueError("odd degree needs an even number of nodes")
        edges = set()
        for i in range(n):
            for step in range(1, k // 2 + 1):
                edges.add(tuple(sorted((i, (i + step) % n))))
            if k % 2 == 1:
                edges.add(tuple(sorted((i, (i + n // 2) % n))))
        return cls._symmetric(n, edges, link, f"{k}-regular")

    @classmethod
    def small_world(cls, n: int, k: int, p: float, seed: int = 0,
                    link: Link = _DEFAULT_LINK) -> "Topology":
        """Watts-Strogatz: start from the circulant k-regular ring lattice,
        rewire each edge's far endpoint with probability ``p`` to a uniform
        non-neighbour.  Deterministic in ``seed`` (stdlib ``random``), so
        ``from_trace`` round-trips byte-identically."""
        if not 2 <= k < n:
            raise ValueError(f"need 2 <= k < n, got k={k}, n={n}")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"rewire probability must be in [0, 1], got {p}")
        rng = random.Random(f"{seed}:smallworld-rewire")
        edges: set[tuple[int, int]] = set()
        for i in range(n):
            for step in range(1, k // 2 + 1):
                edges.add(tuple(sorted((i, (i + step) % n))))
            if k % 2 == 1 and n % 2 == 0:
                edges.add(tuple(sorted((i, (i + n // 2) % n))))
        # rewire in sorted-edge order: iteration order (hence the rewired
        # graph) is a pure function of (n, k, p, seed)
        for i, j in sorted(edges):
            if rng.random() >= p:
                continue
            adjacent = {a for a, b in edges if b == i} | \
                       {b for a, b in edges if a == i}
            candidates = [v for v in range(n)
                          if v != i and v not in adjacent]
            if not candidates:
                continue
            edges.discard((i, j))
            edges.add(tuple(sorted((i, rng.choice(candidates)))))
        return cls._symmetric(n, edges, link, "small-world")

    @classmethod
    def from_trace(cls, trace: Mapping) -> "Topology":
        """Build from a JSON-serialisable dict.

        {"n": 5, "kind": "full" | "star" | "ring" | "k_regular" | "small_world",
         "k": 2, "center": 0, "p": 0.1, "seed": 0,
         "default": {"bandwidth": 12.5e6, "latency": 0.02},
         "links": {"0-1": {"bandwidth": 1e6, "latency": 0.1}, ...},
         "schedule": [{"t": 2.0, "link": "0-1", "down": true}, ...]}

        ``links`` entries override the builder's default on both directions;
        ``schedule`` entries are ``LinkSchedule`` churn events (optional).
        """
        n = int(trace["n"])
        default = trace.get("default")
        link = (
            Link(float(default["bandwidth"]), float(default.get("latency", 0.0)))
            if default
            else _DEFAULT_LINK
        )
        kind = trace.get("kind", "full")
        if kind == "full":
            topo = cls.full(n, link)
        elif kind == "star":
            topo = cls.star(n, int(trace.get("center", 0)), link)
        elif kind == "ring":
            topo = cls.ring(n, link)
        elif kind == "k_regular":
            topo = cls.k_regular(n, int(trace["k"]), link)
        elif kind == "small_world":
            topo = cls.small_world(
                n, int(trace["k"]), float(trace.get("p", 0.1)),
                int(trace.get("seed", 0)), link,
            )
        else:
            raise ValueError(f"unknown topology kind {kind!r}")
        for key, spec in (trace.get("links") or {}).items():
            i, j = (int(x) for x in key.split("-"))
            override = Link(
                float(spec["bandwidth"]), float(spec.get("latency", 0.0))
            )
            if not topo.has_edge(i, j):
                raise ValueError(f"override for absent edge {key!r}")
            topo._links[(i, j)] = override
            topo._links[(j, i)] = override
        sched = trace.get("schedule")
        if sched:
            schedule = LinkSchedule.from_trace(sched)
            _validate_schedule(schedule, n)
            topo.schedule = schedule
        return topo

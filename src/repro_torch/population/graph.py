"""The timestamped, content-addressed compute graph the trace phase emits.

Counterpart of ``repro.population.graph``, on the port's own
``repro_torch.canon``: the same records, node ids and bytes.

A ``TraceNode`` is one unit of schedulable work — ``train`` (one sampled
hospital's local round), ``aggregate`` (the facilitator's reduce +
model step), or ``eval`` — with simulated start/end timestamps and
data-dependency edges (``deps``).  Node ids are content hashes of the
node's own record plus its dependencies' ids, so the id of any node pins
the entire causal history beneath it (a Merkle DAG): two traces agree on a
node id iff they agree on everything that node's result could depend on.

``ComputeGraph.to_json_bytes()`` is the canonical serialisation — sorted
keys, fixed separators, no floats beyond their ``repr`` — and the byte
string the determinism contract (DESIGN.md §10, enforced by
``tests/test_torch_population.py`` and ``python -m repro_torch.population
--check-determinism``) is stated over: same spec + seed ⇒ byte-identical graph.  ``graph_hash()``
is the sha256 of those bytes, the solve phase's cache key.

Stdlib-only: the trace phase never loads torch.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from repro_torch.canon import bytes_hash, canonical_json_bytes, content_hash

KINDS = ("train", "aggregate", "eval")


@dataclasses.dataclass(frozen=True)
class TraceNode:
    """One schedulable unit of the traced computation."""

    id: str                      # content hash (assigned by ComputeGraph.add)
    kind: str                    # train | aggregate | eval
    round: int
    hospital: int                # owner (train: the hospital; aggregate/eval:
                                 # the facilitator)
    t_start: float               # simulated seconds
    t_end: float
    size: int                    # train: examples; aggregate: cohort delivered
    deps: tuple[str, ...]        # data-dependency edge ids
    delivered: bool = True       # train only: upload reached the facilitator

    def record(self) -> dict:
        d = dataclasses.asdict(self)
        d["deps"] = list(self.deps)
        return d


def _node_id(record: dict) -> str:
    material = {k: v for k, v in record.items() if k != "id"}
    return content_hash(material)


class ComputeGraph:
    """Append-only DAG of ``TraceNode``s in topological (trace) order."""

    def __init__(self) -> None:
        self.nodes: list[TraceNode] = []
        self._by_id: dict[str, TraceNode] = {}

    def __len__(self) -> int:
        return len(self.nodes)

    def add(
        self,
        kind: str,
        *,
        round: int,
        hospital: int,
        t_start: float,
        t_end: float,
        size: int,
        deps: Iterable[str] = (),
        delivered: bool = True,
    ) -> TraceNode:
        if kind not in KINDS:
            raise ValueError(f"kind {kind!r} not in {KINDS}")
        deps = tuple(deps)
        for d in deps:
            if d not in self._by_id:
                raise ValueError(f"dep {d!r} not in graph (topological order "
                                 "violated)")
        record = {
            "kind": kind, "round": round, "hospital": hospital,
            # repr-stable rounding: timestamps are sums of spec-derived
            # floats, identical across re-traces of the same spec
            "t_start": round_ts(t_start), "t_end": round_ts(t_end),
            "size": size, "deps": list(deps), "delivered": delivered,
        }
        node = TraceNode(
            id=_node_id(record), kind=kind, round=round, hospital=hospital,
            t_start=record["t_start"], t_end=record["t_end"], size=size,
            deps=deps, delivered=delivered,
        )
        self.nodes.append(node)
        self._by_id[node.id] = node
        return node

    def get(self, node_id: str) -> TraceNode:
        return self._by_id[node_id]

    # -- topological scheduling ----------------------------------------------

    def waves(self) -> list[list[TraceNode]]:
        """Kahn topological waves: wave k holds every node whose deps all
        live in waves < k.  The solve phase executes wave by wave; within a
        wave, train leaves batch into one fused dispatch."""
        depth: dict[str, int] = {}
        out: list[list[TraceNode]] = []
        for node in self.nodes:  # append order is already topological
            d = 1 + max((depth[dep] for dep in node.deps), default=-1)
            depth[node.id] = d
            while len(out) <= d:
                out.append([])
            out[d].append(node)
        return out

    # -- canonical serialisation ----------------------------------------------

    def to_json_bytes(self) -> bytes:
        """THE canonical byte encoding (determinism contract target)."""
        payload = {"schema": 1, "nodes": [n.record() for n in self.nodes]}
        return canonical_json_bytes(payload)

    def graph_hash(self) -> str:
        return bytes_hash(self.to_json_bytes(), chars=20)

    @classmethod
    def from_json_bytes(cls, raw: bytes) -> "ComputeGraph":
        payload = json.loads(raw.decode())
        g = cls()
        for rec in payload["nodes"]:
            node = TraceNode(
                id=rec["id"], kind=rec["kind"], round=rec["round"],
                hospital=rec["hospital"], t_start=rec["t_start"],
                t_end=rec["t_end"], size=rec["size"],
                deps=tuple(rec["deps"]), delivered=rec["delivered"],
            )
            if _node_id(node.record()) != node.id:
                raise ValueError(f"corrupt graph: node {node.id} fails its "
                                 "content hash")
            g.nodes.append(node)
            g._by_id[node.id] = node
        return g


def round_ts(t: float) -> float:
    """Timestamp canonicalisation: microsecond grid, repr-stable."""
    return round(float(t), 6)

"""The trace phase: discrete-event simulation with NO model compute.

Counterpart of ``repro.population.trace``, the same arithmetic in the
same order, so graphs, plans and counters are the reference's for the
same nodes, topology, sizes and facilitator.

The ``sim`` backend interleaves event scheduling with model compute, so
simulating a hospital costs a model step — H=1000 is unreachable.  The trace phase breaks that weld: it walks the synchronous
round structure (cohort sample → download → local compute → upload →
aggregate) purely as *timestamp arithmetic* over the node/topology traces,
using each hospital's **expected** batch size for compute time (the actual
Poisson draws happen at solve time, inside the arm's own rng stream), and
emits two artifacts:

  * a content-addressed ``ComputeGraph`` (train/aggregate/eval nodes with
    data-dependency edges) — byte-identical for a fixed spec + seed;
  * a compact per-round ``RoundPlan`` list the solver walks (who was
    sampled, who delivered, who dropped mid-round, where time went).

Sparse topologies are first-class: uploads route along min-hop BFS paths
to the facilitator, paying every edge's latency + serialisation and
charging bytes per traversed link (relay cost is real traffic).  SecAgg is
modeled at the aggregate level: when the arm declares ``secure_uploads``
the trace charges the existing setup/recovery byte math
(``core.secagg.secagg_recovery_bytes``) — no per-event ciphertext service
runs (the ``population`` backend is capability-negotiated accordingly).

Stdlib + ``repro_torch.sim`` data types only — importing this module
loads no torch (the recovery-byte model is imported when first used).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Sequence

from repro_torch.population.graph import ComputeGraph, round_ts
from repro_torch.population.sampler import CohortSampler
from repro_torch.sim.nodes import HospitalNode
from repro_torch.sim.topology import Topology


@dataclasses.dataclass
class RoundPlan:
    """What the trace decided for one protocol round (solver input)."""

    t: int
    start: float
    end: float
    dst: int
    cohort: tuple[int, ...]          # sampled ∩ online at round start
    delivered: tuple[int, ...]       # uploads that reached dst
    dropped: tuple[int, ...]         # sampled but lost mid-round
    lost: bool                       # round void (quorum/dst/threshold)
    reason: str = ""                 # why it was lost ("" = completed)


@dataclasses.dataclass
class Trace:
    """The trace phase's full output."""

    graph: ComputeGraph
    rounds: list[RoundPlan]
    wall_clock: float                # simulated seconds at trace end
    bytes_on_wire: float
    dropout_events: int
    recoveries: int                  # aggregate-level SecAgg recoveries
    lost_rounds: int
    events: int                      # trace decisions taken (graph+round ops)
    empirical_q: float
    mean_cohort: float


def _online_at(node: HospitalNode, t: float) -> bool:
    for t_off, t_on in node.dropouts:
        if t_off <= t and (t_on is None or t < t_on):
            return False
    return True


def _next_transition(nodes: Sequence[HospitalNode], t: float) -> float | None:
    """Earliest availability boundary strictly after ``t`` (quorum stall)."""
    best: float | None = None
    for node in nodes:
        for t_off, t_on in node.dropouts:
            for b in (t_off, t_on):
                if b is not None and b > t and (best is None or b < best):
                    best = b
    return best


def _drops_within(node: HospitalNode, t0: float, t1: float) -> bool:
    """Does a dropout window open inside (t0, t1]? (mid-round loss)"""
    return any(t0 < t_off <= t1 for t_off, _ in node.dropouts)


def _path_costs(
    topo: Topology, dst: int, nbytes: float
) -> tuple[dict[int, int], dict[int, float]]:
    """BFS from ``dst``: min-hop count and summed per-edge transfer time for
    shipping ``nbytes`` from every reachable node to ``dst``."""
    hops = {dst: 0}
    cost = {dst: 0.0}
    q: deque[int] = deque([dst])
    while q:
        u = q.popleft()
        for v in topo.neighbors(u):
            if v not in hops:
                hops[v] = hops[u] + 1
                # store-and-forward: each hop pays latency + serialisation
                cost[v] = cost[u] + topo.transfer_time(v, u, nbytes)
                q.append(v)
    return hops, cost


def run_trace(
    nodes: Sequence[HospitalNode],
    topo: Topology,
    *,
    rounds: int,
    q: float,
    seed: int,
    sizes: Sequence[int],                 # expected examples per hospital round
    model_bytes: float,
    secure: bool,                          # model SecAgg setup/recovery cost
    quorum: int,
    require: int | None,                   # node that must be online (star hub)
    facilitator: Callable[[int, Sequence[int]], int],
    secagg_threshold: int | None = None,
    eval_every: int = 0,
) -> Trace:
    """Trace ``rounds`` synchronous rounds over the population."""
    h = len(nodes)
    sampler = CohortSampler(h, q, seed)
    graph = ComputeGraph()
    plans: list[RoundPlan] = []
    now = 0.0
    wire = 0.0
    recoveries = 0
    lost_rounds = 0
    events = 0
    prev_agg_id: tuple[str, ...] = ()    # dep edge: params came from here

    def lose(t: int, start: float, end: float, dst: int, cohort, delivered,
             dropped, reason: str) -> None:
        nonlocal lost_rounds
        lost_rounds += 1
        plans.append(RoundPlan(
            t=t, start=round_ts(start), end=round_ts(end), dst=dst,
            cohort=tuple(cohort), delivered=tuple(delivered),
            dropped=tuple(dropped), lost=True, reason=reason,
        ))

    for t in range(rounds):
        topo.advance_to(now)  # fold scheduled link churn into the graph
        sampled = sampler.cohort(t)
        cohort = [i for i in sampled if _online_at(nodes[i], now)]
        events += 1
        hub_down = require is not None and not _online_at(nodes[require], now)
        if len(cohort) < max(quorum, 1) or hub_down:
            # stall to the next availability transition, like the event
            # backend's quorum wait — if none remains, the run is over
            nxt = _next_transition(nodes, now)
            lose(t, now, now, -1, cohort, (), (),
                 "hub offline" if hub_down else "below quorum")
            if nxt is None:
                break
            now = nxt
            continue
        dst = facilitator(t, cohort)
        # uploads and downloads both ship one model copy, so one BFS covers
        # both directions (links are symmetric by construction)
        hops, upcost = _path_costs(topo, dst, model_bytes)
        dlcost = upcost

        delivered: list[int] = []
        dropped: list[int] = []
        train_ids: list[str] = []
        t_last_arrival = now
        for i in cohort:
            if i not in hops:
                dropped.append(i)   # partitioned from the facilitator
                graph.add("train", round=t, hospital=i, t_start=now,
                          t_end=now, size=int(sizes[i]), deps=prev_agg_id,
                          delivered=False)
                events += 1
                continue
            dl = dlcost[i]                       # model download to i
            t_start = now + dl
            t_compute = nodes[i].compute_time(int(sizes[i]))
            t_up = upcost[i]                      # upload back to dst
            t_arrive = t_start + t_compute + t_up
            # bytes ride every traversed link, both directions
            wire += hops[i] * model_bytes * 2
            ok = not _drops_within(nodes[i], now, t_arrive)
            node = graph.add(
                "train", round=t, hospital=i, t_start=t_start,
                t_end=t_start + t_compute, size=int(sizes[i]),
                deps=prev_agg_id, delivered=ok,
            )
            events += 1
            if ok:
                delivered.append(i)
                train_ids.append(node.id)
                t_last_arrival = max(t_last_arrival, t_arrive)
            else:
                dropped.append(i)

        if secure:
            wire += _recovery_bytes(len(cohort))["setup_bytes"]
        dst_dead = dst in dropped or _drops_within(nodes[dst], now,
                                                   t_last_arrival)
        if dst_dead or not delivered:
            lose(t, now, t_last_arrival, dst, cohort, delivered, dropped,
                 "facilitator died" if dst_dead else "nothing delivered")
            now = max(now, t_last_arrival)
            continue
        t_agg = t_last_arrival
        if secure:
            threshold = secagg_threshold or (len(cohort) // 2 + 1)
            if len(delivered) < threshold:
                lose(t, now, t_agg, dst, cohort, delivered, dropped,
                     "below secagg threshold")
                now = t_agg
                continue
            if dropped:
                # survivors reveal the dropped secrets' shares: one extra
                # latency-bound round trip plus the recovery bytes
                recoveries += len(dropped)
                wire += _recovery_bytes(len(cohort),
                                        len(dropped))["recovery_bytes"]
                t_agg += 2 * max(
                    hops[i] * _min_latency(topo, i) for i in delivered
                )
        agg = graph.add(
            "aggregate", round=t, hospital=dst, t_start=t_last_arrival,
            t_end=t_agg, size=len(delivered), deps=tuple(train_ids),
        )
        events += 1
        prev_agg_id = (agg.id,)
        if eval_every and (t + 1) % eval_every == 0:
            ev = graph.add("eval", round=t, hospital=dst, t_start=t_agg,
                           t_end=t_agg, size=len(delivered), deps=(agg.id,))
            events += 1
            del ev
        plans.append(RoundPlan(
            t=t, start=round_ts(now), end=round_ts(t_agg), dst=dst,
            cohort=tuple(cohort), delivered=tuple(delivered),
            dropped=tuple(dropped), lost=False,
        ))
        now = t_agg

    n_dropout_events = sum(
        sum(1 for t_off, _ in node.dropouts if t_off <= now)
        for node in nodes
    )
    completed = [p for p in plans if not p.lost]
    mean_cohort = (sum(len(p.cohort) for p in plans) / len(plans)
                   if plans else 0.0)
    return Trace(
        graph=graph, rounds=plans, wall_clock=round_ts(now),
        bytes_on_wire=wire, dropout_events=n_dropout_events,
        recoveries=recoveries, lost_rounds=lost_rounds, events=events,
        empirical_q=sampler.empirical_rate(), mean_cohort=mean_cohort,
    )


def _min_latency(topo: Topology, i: int) -> float:
    nbrs = topo.neighbors(i)
    if not nbrs:
        return 0.0
    return min(topo.link(i, j).latency for j in nbrs)


def _recovery_bytes(n: int, dropped: int = 0) -> dict:
    from repro_torch.core.secagg import secagg_recovery_bytes

    return secagg_recovery_bytes(n, dropped) if dropped else \
        secagg_recovery_bytes(n)

"""The two host execution backends that consume registered arms.

Counterpart of ``repro.arms.runners``; both register with the backend
registry (``arms.backends``).  ``LocalRunner`` (``ideal``) is the
idealized lockstep executor: every hospital infinitely fast and always
online, free communication — the paper's utility experiments.
``SimRunner`` (``sim``) drives the same arm object through the
discrete-event engine (``repro_torch.sim``), adding simulated wall-clock,
bytes on the wire, stragglers, dropouts and SecAgg mask recovery.

Backend-level services, never implemented inside an arm:

  * secure aggregation — ``SecAggSession`` sums (``secure_sum``) on the
    idealized backend, ``DropoutRobustSession`` ciphertexts and Shamir
    recovery on the simulated one; either way the batch of payloads leaves
    the card in one copy per round (``fused.build_contributions``);
  * without SecAgg, sums on the card: the fused round's own ascending
    fold on ``ideal``, the same fold over the delivered payloads (device
    trees) on ``sim``, so the two agree bit for bit;
  * the DP noise top-up when shares were lost to a dropout;
  * gossip pairwise averaging, in place on the card;
  * the transport itself: gathers, broadcasts, and their byte accounting.
"""

from __future__ import annotations

import itertools
from typing import Any, Mapping, Sequence

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.arms import fused
from repro_torch.arms.backends import BackendInfo, RunSetup, register_backend
from repro_torch.arms.base import (
    AggregationServices,
    Arm,
    Contribution,
    NodeArm,
    RoundArm,
    tree_bytes,
    tree_sum,
)
from repro_torch.arms.results import RoundLog, RunReport, SimTiming
from repro_torch.core import dp as dp_lib
from repro_torch.core.secagg import (
    DropoutRobustSession,
    SecAggConfig,
    secagg_recovery_bytes,
    secure_sum,
    secure_sum_ints,
)
from repro_torch.sim.engine import (
    ComputeDone,
    EventEngine,
    NodeDropout,
    NodeRejoin,
    TransferDone,
)
from repro_torch.sim.nodes import HospitalNode
from repro_torch.sim.topology import Topology
from repro_torch.tree import Tree, tree_device, tree_leaves

_SHARE_BYTES = 16.0  # one Shamir share on the wire (index + 61-bit y)


def default_topology(kind: str, n: int, center: int = 0) -> Topology:
    """The natural topology for an arm's ``topology_kind``."""
    if kind == "star":
        return Topology.star(n, center)
    if kind == "ring":
        return Topology.ring(n)
    return Topology.full(n)


def _contributions(arm: RoundArm, params, active, t, rng, payloads
                   ) -> tuple[dict[int, Contribution], Tree | None]:
    """The round's contributions: the fused cohort step (one program call)
    when the config and the arm have one, else the per-participant loop in
    ascending index (the arm-contract rng order)."""
    if arm.cfg.fused_rounds and arm.fused_capable:
        with obs.span("fused_round", cat="train", device_time=True, t=t,
                      cohort=len(active)):
            return arm.fused_round(params, active, t, rng, len(active),
                                   payloads=payloads)
    contribs = {}
    for i in active:
        c = arm.contribution(params, i, t, rng, len(active))
        if c is not None:
            contribs[i] = c
    return contribs, None


# -- aggregation services ----------------------------------------------------


class _IdealServices(AggregationServices):
    """Free, lossless aggregation: SecAgg over every payload tree when
    ``secure``, else the fused round's reduced sum on the device (or the
    same fold over device payloads from the per-participant loop)."""

    def __init__(self, cfg, n: int, t: int, secure: bool, device,
                 fused_reduced: Tree | None, cover: frozenset[int]) -> None:
        self._cfg, self._n, self._t, self._secure = cfg, n, t, secure
        self._device = device
        self.fused_reduced = fused_reduced
        self._cover = cover

    def sum_sizes(self, sizes: Sequence[int]) -> int:
        if self._secure:
            # aggregate mini-batch size ||B^t|| via SecAgg — summed in the
            # field as integers (exact, no float fixed-point round-trip)
            return secure_sum_ints(
                list(sizes), n_participants=self._n,
                seed=self._cfg.seed * 7919 + self._t,
            )
        return int(sum(sizes))

    def sum_payloads(self, payloads: Mapping[int, Tree]) -> Tree:
        if self.fused_reduced is not None and set(payloads) == self._cover:
            return self.fused_reduced
        trees = [payloads[i] for i in sorted(payloads)]
        if self._secure:
            if len(trees) != self._n:
                raise ValueError(
                    "idealized SecAgg needs every participant's upload "
                    f"({len(trees)} of {self._n})"
                )
            return secure_sum(
                trees,
                SecAggConfig(self._n, self._cfg.secagg_frac_bits,
                             seed=self._cfg.seed + self._t),
                device=self._device,
            )
        if any(tr is None for tr in trees):
            raise RuntimeError(
                "the fused round's reduced sum does not cover this "
                "aggregation — arm and backend disagree about the cohort"
            )
        return fused.seq_tree_sum(trees)


class _SimServices(AggregationServices):
    """Sums over what actually arrived: the dropout-robust session over the
    gathered ciphertexts, else the ascending fold of the delivered device
    payloads; plus the noise top-up the backend owes for lost shares."""

    def __init__(self, session, uploads: dict[int, Any] | None,
                 topup: Tree | None = None) -> None:
        self._session, self._uploads = session, uploads
        self._topup = topup

    def sum_sizes(self, sizes: Sequence[int]) -> int:
        return int(sum(sizes))

    def sum_payloads(self, payloads: Mapping[int, Tree]) -> Tree:
        if self._session is not None:
            # the session cancels the dropped participants' pads (rebuilt by
            # its ``recover`` in the round's secagg.recover span)
            total = self._session.aggregate(self._uploads)
        else:
            total = fused.seq_tree_sum([payloads[i] for i in sorted(payloads)])
        if self._topup is not None:
            # dropped participants took their noise shares with them: the
            # backend owes the difference (DESIGN.md §10)
            total = tree_sum([total, self._topup])
        return total


def _average_pair(per_node: list[Tree], i: int, j: int) -> None:
    """Backend service: atomic pairwise model averaging (AD-PSGD style),
    ``0.5 * (a + b)`` into both nodes' own tensors, in place."""
    for a, b in zip(tree_leaves(per_node[i]), tree_leaves(per_node[j])):
        a.add_(b).mul_(0.5)
        b.copy_(a)


def _mean_loss(losses: Sequence[torch.Tensor]) -> float:
    """The float64 mean of a lockstep's losses, in one host sync."""
    host = torch.stack([l.detach().float() for l in losses]).cpu().numpy()
    return float(np.mean(host.astype(np.float64)))


# -- idealized backend -------------------------------------------------------


@register_backend(BackendInfo(
    name="ideal",
    supports_fused=True,
    supports_secagg=True,
    supports_sim_time=False,
    bit_exact_group="host",
    description="idealized lockstep: every hospital infinitely fast and "
                "always online, communication free",
))
class LocalRunner:
    """Idealized lockstep execution of any registered arm."""

    def __init__(self, topo: Topology | None = None, on_round=None) -> None:
        self.topo = topo  # only node arms (gossip) consult it
        self.on_round = on_round  # on_round(t, params) after each round

    @classmethod
    def from_setup(cls, setup: RunSetup) -> "LocalRunner":
        return cls(topo=setup.topo, on_round=setup.on_round)

    def run(self, arm: Arm) -> RunReport:
        if isinstance(arm, RoundArm):
            return self._run_rounds(arm)
        if isinstance(arm, NodeArm):
            return self._run_nodes(arm)
        raise TypeError(f"unknown arm mode {arm.mode!r} for {arm.name!r}")

    def _contributions(self, arm: RoundArm, params, active, t, rng,
                       payloads) -> tuple[dict[int, Contribution],
                                          Tree | None]:
        """The round's contributions (``_contributions``): the seam the
        ``shard`` backend runs on its mesh."""
        return _contributions(arm, params, active, t, rng, payloads)

    def _run_rounds(self, arm: RoundArm) -> RunReport:
        cfg, h = arm.cfg, arm.h
        params = arm.init_params()
        model_bytes = tree_bytes(params, cfg.bytes_per_param)
        rng = np.random.default_rng(cfg.seed)
        logs: list[RoundLog] = []
        for t in range(arm.planned_rounds()):
            with obs.span("round", cat="train", device_time=True,
                          arm=arm.name, backend=self.backend, t=t):
                active = [i for i in range(h) if arm.participates(i, t)]
                if not active:
                    break  # nobody left who can contribute
                dst = arm.facilitator(t, active)
                secure = arm.secure_uploads and cfg.use_secagg
                # one program call for the whole cohort; with SecAgg off
                # the reduced aggregate never leaves the device, with it on
                # the payloads leave in one copy and nothing is reduced
                contribs, reduced = self._contributions(
                    arm, params, active, t, rng, "host" if secure else None)
                if not contribs:
                    if arm.empty_break:
                        break
                    continue
                services = _IdealServices(cfg, h, t, secure,
                                          tree_device(params), reduced,
                                          frozenset(contribs))
                # SecAgg (when on) runs inside aggregate via the services;
                # the span covers the secure sums and the model step
                with obs.span("aggregate", cat="train", device_time=True,
                              t=t, secure=secure):
                    outcome = arm.aggregate(params, contribs, services)
                if outcome.stepped:
                    params = outcome.params
                    arm.account()
                    obs.counter("rounds_completed", 1)
                    obs.ledger_round(arm, round=t, backend=self.backend,
                                     cohort=active, delivered=contribs,
                                     bytes_up=model_bytes)
                    logs.append(RoundLog(t, dst, outcome.loss, arm.epsilon(),
                                         outcome.aggregate_batch))
                    if self.on_round is not None:
                        self.on_round(t, params)
                    if arm.should_stop():
                        break
                elif arm.void_logs:
                    logs.append(RoundLog(t, dst, float("nan"), arm.epsilon(),
                                         0))
        return RunReport(
            params=params, logs=logs, epsilon=arm.epsilon(),
            rounds_completed=len(logs), arm=arm.name, backend=self.backend,
        )

    def _run_nodes(self, arm: NodeArm) -> RunReport:
        cfg, h = arm.cfg, arm.h
        topo = self.topo or default_topology(arm.topology_kind, h,
                                             cfg.fl_server)
        per_node = [arm.init_node_params(i) for i in range(h)]
        steps_done = [0] * h
        retired = [False] * h
        logs: list[RoundLog] = []
        for s in range(arm.steps_total()):
            losses, consumed, stepped = [], 0, []
            for i in range(h):
                if retired[i]:
                    continue
                r = arm.local_step(i, per_node[i], steps_done[i])
                if r is None:
                    retired[i] = True
                    continue
                per_node[i], loss, k = r
                steps_done[i] += 1
                losses.append(loss)
                consumed += k
                stepped.append(i)
            if not stepped:
                break  # every node retired
            # exchanges fire in ascending node order — the same order an
            # ideal uniform trace delivers them under the event backend
            for i in stepped:
                if arm.wants_exchange(i, steps_done[i]):
                    j = arm.select_peer(i, topo.neighbors(i))
                    if j is not None:
                        _average_pair(per_node, i, j)
            logs.append(RoundLog(s, -1, _mean_loss(losses), arm.epsilon(),
                                 consumed))
        params, per_node = arm.consensus(per_node)
        if self.on_round is not None:
            # node arms have no server rounds; publish the consensus model
            # once, stamped with the completed step count
            self.on_round(min(steps_done), params)
        return RunReport(
            params=params, logs=logs, epsilon=arm.epsilon(),
            rounds_completed=min(steps_done), arm=arm.name,
            backend=self.backend, per_node_params=per_node,
        )


# -- simulated-time backend --------------------------------------------------

# Every gather/broadcast stamps its events with a unique tag.  Events from a
# voided round can outlive the round (a dropped node's in-flight upload); the
# tag match keeps them from being mistaken for the current round's traffic.
_tag_counter = itertools.count()


@register_backend(BackendInfo(
    name="sim",
    supports_fused=True,
    supports_secagg=True,
    supports_sim_time=True,
    bit_exact_group="host",
    description="discrete-event engine: simulated wall-clock, bytes-on-wire, "
                "stragglers, dropouts, SecAgg mask recovery",
))
class SimRunner:
    """Discrete-event execution of any registered arm."""

    def __init__(self, nodes: Sequence[HospitalNode],
                 topo: Topology | None = None, on_round=None) -> None:
        self.nodes = list(nodes)
        self.topo = topo  # None -> the arm's natural topology, resolved in run
        self.on_round = on_round
        # re-resolve per run: a reused runner must not pin the FIRST arm's
        # natural topology onto a second arm with a different topology_kind
        self._auto_topo = topo is None

    @classmethod
    def from_setup(cls, setup: RunSetup) -> "SimRunner":
        if setup.nodes is None:
            raise ValueError("backend 'sim' needs nodes= (HospitalNode list)")
        return cls(setup.nodes, setup.topo, on_round=setup.on_round)

    def _pop(self, engine: EventEngine):
        """Pop the next event, folding scheduled link churn into the topology
        up to the new simulated time before any link is consulted."""
        ev = engine.pop()
        if ev is not None:
            self.topo.advance_to(engine.now)
        return ev

    def run(self, arm: Arm) -> RunReport:
        if len(self.nodes) != arm.h:
            raise ValueError("one HospitalNode per participant required")
        if self._auto_topo:
            self.topo = default_topology(arm.topology_kind, len(self.nodes),
                                         arm.cfg.fl_server)
        self.topo.advance_to(0.0)  # fold in any t=0 schedule entries
        if isinstance(arm, RoundArm):
            return self._run_rounds(arm)
        if isinstance(arm, NodeArm):
            return self._run_nodes(arm)
        raise TypeError(f"unknown arm mode {arm.mode!r} for {arm.name!r}")

    # --- shared engine plumbing ---------------------------------------------

    def _engine(self) -> EventEngine:
        engine = EventEngine()
        for node in self.nodes:
            for t_off, t_on in node.dropouts:
                engine.schedule_at(t_off, NodeDropout(node.index))
                if t_on is not None:
                    engine.schedule_at(t_on, NodeRejoin(node.index))
        return engine

    def _apply_availability(self, ev) -> bool:
        """Handle dropout/rejoin events; True if ``ev`` was one of them."""
        if isinstance(ev, NodeDropout):
            self.nodes[ev.node].online = False
            return True
        if isinstance(ev, NodeRejoin):
            self.nodes[ev.node].online = True
            return True
        return False

    def _advance_to_quorum(self, engine: EventEngine, minimum: int,
                           require: int | None) -> tuple[int, bool]:
        """Fast-forward availability events until >= minimum nodes online
        (and, if given, node ``require`` — e.g. the star hub — is online)."""
        n_drop = 0
        while (
            sum(n.online for n in self.nodes) < minimum
            or (require is not None and not self.nodes[require].online)
        ):
            ev = self._pop(engine)
            if ev is None:
                return n_drop, False  # quorum never reachable again
            if self._apply_availability(ev):
                n_drop += isinstance(ev, NodeDropout)
        return n_drop, True

    def _gather_round(self, engine: EventEngine, dst: int,
                      work: dict[int, tuple[Any, float, float]]
                      ) -> tuple[dict[int, Any], set[int], float, int]:
        """One synchronous gather: every node computes, then uploads to
        ``dst``.  ``work[i] = (payload, compute_seconds, nbytes)``.  Returns
        ``(delivered, dropped_mid_round, bytes_on_wire, dropout_events)``.
        A node whose NodeDropout fires before its upload lands is excluded
        from ``delivered`` — exactly the case SecAgg recovery must handle."""
        nodes, topo = self.nodes, self.topo
        tag = f"sync-{next(_tag_counter)}"
        pending = set(work)
        delivered: dict[int, Any] = {}
        dropped_mid: set[int] = set()
        inflight: dict[int, int] = {}  # node -> cancel handle of next event
        wire = 0.0
        n_drop = 0
        for i, (payload, compute_s, nbytes) in work.items():
            inflight[i] = engine.schedule(
                compute_s, ComputeDone(i, tag=tag, payload=(payload, nbytes))
            )
        while pending:
            ev = self._pop(engine)
            if ev is None:
                break
            if self._apply_availability(ev):
                if isinstance(ev, NodeDropout):
                    n_drop += 1
                    if ev.node in pending:
                        pending.discard(ev.node)
                        dropped_mid.add(ev.node)
                        # the dropout kills the compute / connection: its
                        # upload must never arrive, so the aggregator never
                        # holds both a "dropped" ciphertext and its
                        # reconstructed pads
                        handle = inflight.pop(ev.node, None)
                        if handle is not None:
                            engine.cancel(handle)
                continue
            if isinstance(ev, ComputeDone) and ev.tag == tag:
                if not nodes[ev.node].online:
                    continue  # dropped during compute; already counted
                payload, nbytes = ev.payload
                if ev.node == dst:
                    delivered[ev.node] = payload
                    pending.discard(ev.node)
                    inflight.pop(ev.node, None)
                elif not topo.has_edge(ev.node, dst):
                    # link churn severed the path before the upload started;
                    # from the aggregator's view the node dropped mid-round
                    pending.discard(ev.node)
                    dropped_mid.add(ev.node)
                    inflight.pop(ev.node, None)
                else:
                    wire += nbytes
                    inflight[ev.node] = engine.schedule(
                        topo.transfer_time(ev.node, dst, nbytes),
                        TransferDone(ev.node, dst, nbytes, tag=tag,
                                     payload=payload),
                    )
            elif isinstance(ev, TransferDone) and ev.tag == tag:
                if ev.src in pending:
                    delivered[ev.src] = ev.payload
                    pending.discard(ev.src)
                    inflight.pop(ev.src, None)
        return delivered, dropped_mid, wire, n_drop

    def _broadcast(self, engine: EventEngine, src: int, nbytes: float,
                   targets: Sequence[int]) -> tuple[float, int]:
        """Send ``nbytes`` from ``src`` to each online target; barrier on
        arrival."""
        nodes, topo = self.nodes, self.topo
        tag = f"bcast-{next(_tag_counter)}"
        outstanding = 0
        wire = 0.0
        n_drop = 0
        for j in targets:
            if j == src or not nodes[j].online or not topo.has_edge(src, j):
                continue
            wire += nbytes
            outstanding += 1
            engine.schedule(
                topo.transfer_time(src, j, nbytes),
                TransferDone(src, j, nbytes, tag=tag),
            )
        while outstanding:
            ev = self._pop(engine)
            if ev is None:
                break
            if self._apply_availability(ev):
                n_drop += isinstance(ev, NodeDropout)
                continue
            if isinstance(ev, TransferDone) and ev.tag == tag:
                outstanding -= 1
        return wire, n_drop

    def _gather_shares(self, engine: EventEngine, dst: int,
                       delivered: Mapping[int, Any]) -> int:
        """Time cost of the Shamir share gather (tiny, latency-bound)."""
        tag = f"shares-{next(_tag_counter)}"
        surv = [i for i in delivered
                if i != dst and self.topo.has_edge(i, dst)]
        for j in surv:
            engine.schedule(
                self.topo.transfer_time(j, dst, _SHARE_BYTES),
                TransferDone(j, dst, _SHARE_BYTES, tag=tag),
            )
        outstanding = len(surv)
        n_drop = 0
        while outstanding:
            ev = self._pop(engine)
            if ev is None:
                break
            if self._apply_availability(ev):
                n_drop += isinstance(ev, NodeDropout)
                continue
            if isinstance(ev, TransferDone) and ev.tag == tag:
                outstanding -= 1
        return n_drop

    # --- round-based arms ----------------------------------------------------

    def _run_rounds(self, arm: RoundArm) -> RunReport:
        cfg, h = arm.cfg, arm.h
        nodes = self.nodes
        params = arm.init_params()
        rng = np.random.default_rng(cfg.seed)
        model_bytes = tree_bytes(params, cfg.bytes_per_param)
        engine = self._engine()
        wire = 0.0
        dropouts = recoveries = lost = completed = topups = 0
        logs: list[RoundLog] = []
        minimum, require = arm.quorum()
        secure = arm.secure_uploads and cfg.use_secagg

        # planned_rounds() pre-caps for an epsilon budget exactly like the
        # idealized backend
        for t in range(arm.planned_rounds()):
            with obs.span("round", cat="train", device_time=True,
                          arm=arm.name, backend=self.backend, t=t):
                d, ok = self._advance_to_quorum(engine, minimum, require)
                dropouts += d
                if not ok:
                    break
                active = [i for i in range(h)
                          if nodes[i].online and arm.participates(i, t)]
                if not active:
                    if arm.empty_break:
                        break
                    lost += 1
                    continue
                dst = arm.facilitator(t, active)
                # one program call computes the whole cohort's
                # contributions; the transport below still ships them one
                # by one, so the backend sums what arrives: the payloads
                # come as device trees, or with SecAgg in one host copy
                contribs, _ = _contributions(
                    arm, params, active, t, rng,
                    "host" if secure else "device")
                if not contribs:
                    if arm.empty_break:
                        break
                    lost += 1
                    continue

                session = None
                slot_of: dict[int, int] = {}
                if secure:
                    n_active = len(active)
                    # quorum guarantees n_active >= any configured threshold
                    threshold = cfg.secagg_threshold or (n_active // 2 + 1)
                    session = DropoutRobustSession(
                        SecAggConfig(n_active, cfg.secagg_frac_bits,
                                     seed=cfg.seed * 6007 + t),
                        params, threshold=threshold,
                    )
                    wire += secagg_recovery_bytes(n_active)["setup_bytes"]
                    slot_of = {i: s for s, i in enumerate(active)}

                ciphers = None
                if session is not None:
                    # one masking pass for the whole cohort (each
                    # participant still ships its own ciphertext below)
                    with obs.span("secagg.encode", cat="secagg", t=t,
                                  cohort=len(active)):
                        ciphers = session.upload_all(
                            {slot_of[i]: c.payload
                             for i, c in contribs.items()})
                work = {}
                for i, c in contribs.items():
                    payload = ciphers[slot_of[i]] if ciphers else c.payload
                    work[i] = (payload, nodes[i].compute_time(c.size),
                               model_bytes)
                with obs.span("transport.gather", cat="sim", t=t,
                              uploads=len(work)):
                    delivered, dropped_mid, w, d = self._gather_round(
                        engine, dst, work)
                wire += w
                dropouts += d
                dst_dead = dst in dropped_mid or (
                    not nodes[dst].online if arm.requires_dst_online
                    else dst not in delivered
                )
                if dst_dead:
                    lost += 1
                    continue  # facilitator died mid-round; round is void

                uploads = None
                if session is not None:
                    uploads = {slot_of[i]: delivered[i] for i in delivered}
                    if len(uploads) < session.threshold:
                        lost += 1
                        continue  # below recovery threshold: protocol aborts
                    if dropped_mid:
                        # survivors reveal shares of each dropped secret so
                        # the facilitator can reconstruct it and cancel its
                        # pads (rebuilt here, one at a time, on the host)
                        with obs.span("secagg.recover", cat="secagg", t=t,
                                      dropped=len(dropped_mid)):
                            recoveries += len(dropped_mid)
                            wire += secagg_recovery_bytes(
                                len(active), len(dropped_mid)
                            )["recovery_bytes"]
                            dropouts += self._gather_shares(engine, dst,
                                                            delivered)
                            session.recover(sorted(uploads))

                topup = None
                if dropped_mid and arm.distributed_noise:
                    # every active participant noised its share for a cohort
                    # of len(active); the dropped shares never arrived
                    with obs.span("noise_topup", cat="dp", t=t,
                                  missing=len(dropped_mid)):
                        gen = torch.Generator(device=tree_device(params))
                        gen.manual_seed(dp_lib.noise_seed(
                            cfg.seed * 31 + dp_lib.TOPUP_STREAM, t))
                        topup = dp_lib.tree_topup_noise(
                            params, gen, clip_norm=cfg.dp.clip_norm,
                            noise_multiplier=cfg.dp.noise_multiplier,
                            missing=len(dropped_mid), n_shares=len(active),
                        )
                    obs.counter("noise_topups", 1)
                    topups += 1
                dl_contribs = {i: contribs[i] for i in delivered}
                # secure decode (when a session exists) happens inside
                # aggregate via the services object, so this span covers
                # reduce + recovery + decode
                with obs.span("aggregate", cat="train", device_time=True,
                              t=t, secure=session is not None):
                    outcome = arm.aggregate(
                        params, dl_contribs,
                        _SimServices(session, uploads, topup))
                if not outcome.stepped:
                    lost += 1  # e.g. empty Poisson draw across the cohort
                    continue
                params = outcome.params
                with obs.span("transport.broadcast", cat="sim", t=t):
                    w, d = self._broadcast(
                        engine, dst, model_bytes,
                        [i for i in range(h) if nodes[i].online])
                wire += w
                dropouts += d
                arm.account()
                completed += 1
                obs.counter("rounds_completed", 1)
                obs.ledger_round(arm, round=t, backend=self.backend,
                                 cohort=active, delivered=delivered,
                                 bytes_up=model_bytes,
                                 topup=topup is not None)
                logs.append(RoundLog(t, dst, outcome.loss, arm.epsilon(),
                                     outcome.aggregate_batch))
                if self.on_round is not None:
                    self.on_round(t, params)  # checkpoint-handoff seam
                if arm.should_stop():
                    break

        return RunReport(
            params=params, logs=logs, epsilon=arm.epsilon(),
            rounds_completed=completed, arm=arm.name, backend=self.backend,
            timing=SimTiming(
                wall_clock=engine.now, bytes_on_wire=wire,
                dropout_events=dropouts, recoveries=recoveries,
                lost_rounds=lost, events=engine.processed,
                noise_topups=topups,
            ),
        )

    # --- per-node arms --------------------------------------------------------

    def _run_nodes(self, arm: NodeArm) -> RunReport:
        cfg, h = arm.cfg, arm.h
        nodes, topo = self.nodes, self.topo
        per_node = [arm.init_node_params(i) for i in range(h)]
        model_bytes = tree_bytes(per_node[0], cfg.bytes_per_param)
        total = arm.steps_total()
        engine = self._engine()
        steps_done = [0] * h
        parked = [False] * h
        retired = [False] * h
        wire = 0.0
        dropouts = exchanges = 0
        last_progress = 0.0

        def unfinished(i: int) -> bool:
            return not retired[i] and steps_done[i] < total

        def start_step(i: int) -> None:
            engine.schedule(
                nodes[i].compute_time(arm.step_cost(i)),
                ComputeDone(i, tag="step"),
            )

        def handler(ev) -> None:
            nonlocal wire, dropouts, exchanges, last_progress
            if isinstance(ev, NodeDropout):
                nodes[ev.node].online = False
                dropouts += 1
                return
            if isinstance(ev, NodeRejoin):
                nodes[ev.node].online = True
                if parked[ev.node] and unfinished(ev.node):
                    parked[ev.node] = False
                    start_step(ev.node)
                return
            if isinstance(ev, ComputeDone) and ev.tag == "step":
                i = ev.node
                if not nodes[i].online:
                    parked[i] = True  # step lost mid-compute; redo on rejoin
                    return
                r = arm.local_step(i, per_node[i], steps_done[i])
                if r is None:
                    retired[i] = True  # e.g. local privacy budget exhausted
                    return
                # the loss stays on the card: nothing logs it here
                per_node[i], _loss, _k = r
                steps_done[i] += 1
                last_progress = engine.now
                if arm.wants_exchange(i, steps_done[i]):
                    # skip neighbours currently offline (connection refused);
                    # a neighbour dying mid-transfer is handled at arrival
                    nbrs = [j for j in topo.neighbors(i) if nodes[j].online]
                    j = arm.select_peer(i, nbrs)
                    if j is not None:
                        wire += model_bytes  # outbound leg
                        engine.schedule(
                            topo.transfer_time(i, j, model_bytes),
                            TransferDone(i, j, model_bytes, tag="xchg"),
                        )
                if unfinished(i):
                    start_step(i)  # async: do not wait for the transfer
                return
            if isinstance(ev, TransferDone) and ev.tag == "xchg":
                if nodes[ev.src].online and nodes[ev.dst].online:
                    _average_pair(per_node, ev.src, ev.dst)
                    wire += model_bytes  # return leg only on real exchange
                    exchanges += 1
                    last_progress = engine.now

        for i in range(h):
            if nodes[i].online:
                start_step(i)
            else:
                parked[i] = True
        # run until every node finished/retired and in-flight exchanges land
        while any(unfinished(i) for i in range(h)) or len(engine):
            if not any(unfinished(i) for i in range(h)):
                # only drain transfers that are already in flight
                if engine.pending_kinds() <= {NodeDropout, NodeRejoin}:
                    break  # nothing left that changes the models
            ev = self._pop(engine)
            if ev is None:
                break
            handler(ev)

        params, per_node = arm.consensus(per_node)
        if self.on_round is not None:
            # node arms have no server rounds; publish the consensus model
            # once, stamped with the completed step count
            self.on_round(min(steps_done), params)
        return RunReport(
            params=params, logs=[], epsilon=arm.epsilon(),
            rounds_completed=min(steps_done), arm=arm.name,
            backend=self.backend, per_node_params=per_node,
            timing=SimTiming(
                wall_clock=last_progress, bytes_on_wire=wire,
                dropout_events=dropouts, recoveries=0, lost_rounds=0,
                events=engine.processed,
            ),
        )

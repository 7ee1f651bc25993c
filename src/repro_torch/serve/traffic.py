"""Open-loop traffic: Poisson arrivals, reproducible from one seed.

The port's own copy of ``repro.serve.traffic`` (numpy only).
``generate_requests`` materialises the WHOLE arrival schedule up front from
a single ``np.random.default_rng(seed)`` stream consumed in a fixed order
(gaps, then per-request prompt length / generation budget / prompt tokens),
so the same seed gives the reference's schedule exactly.  Prompt lengths
come from a small discrete bucket set.

``run_open_loop`` replays the schedule against a ``ServeEngine`` in real
time: arrivals enter an admission queue, the queue drains into free slots,
and the engine decodes as fast as it can (open loop: the arrival process
never waits for the server, which is what makes p99 TTFT meaningful under
overload).  Between steps it polls a ``CheckpointWatcher`` for newly
published federation rounds and samples slot occupancy and checkpoint
staleness for the freshness trajectory.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One query: an arrival time, a prompt, and a generation budget.
    Timing fields are filled in by the engine as the request progresses."""

    rid: int
    arrival: float                 # seconds since traffic start
    prompt: np.ndarray             # int32 [prompt_len]
    max_new_tokens: int
    t_admit: float | None = None
    t_first: float | None = None   # first generated token (end of prefill)
    t_done: float | None = None
    round_at_first: int = -1       # checkpoint round serving the first token
    tokens: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Arrival process + per-request draws, all seeded."""

    rate: float                    # mean arrivals / second (Poisson)
    n_requests: int
    vocab_size: int
    prompt_lens: tuple[int, ...] = (8, 16, 32)
    prompt_probs: tuple[float, ...] | None = None   # None -> uniform
    gen_lens: tuple[int, ...] = (8, 16, 32)
    gen_probs: tuple[float, ...] | None = None
    seed: int = 0


def generate_requests(cfg: TrafficConfig) -> list[Request]:
    """The full schedule, deterministic in ``cfg.seed`` (and nothing else)."""
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.rate, cfg.n_requests)
    arrivals = np.cumsum(gaps)
    plens = rng.choice(cfg.prompt_lens, size=cfg.n_requests,
                       p=cfg.prompt_probs)
    gens = rng.choice(cfg.gen_lens, size=cfg.n_requests, p=cfg.gen_probs)
    return [
        Request(
            rid=i,
            arrival=float(arrivals[i]),
            prompt=rng.integers(0, cfg.vocab_size, int(plens[i])
                                ).astype(np.int32),
            max_new_tokens=int(gens[i]),
        )
        for i in range(cfg.n_requests)
    ]


@dataclasses.dataclass
class StepSample:
    """Per-decode-step observability row."""

    t: float                       # seconds since traffic start
    n_active: int                  # occupied slots during the step
    queue_depth: int
    serving_round: int
    latest_round: int              # newest published round at last poll

    @property
    def rounds_behind(self) -> int:
        if self.latest_round < 0:
            return 0
        return max(self.latest_round - max(self.serving_round, -1), 0)


@dataclasses.dataclass
class TraceResult:
    completed: list[Request]
    steps: list[StepSample]
    wall: float                    # harness wall-clock span (seconds)
    swaps: int
    decode_steps: int
    decode_dispatches: int
    admit_dispatches: int


def run_open_loop(
    engine,
    requests: Sequence[Request],
    *,
    watcher=None,
    poll_interval: float = 0.05,
    on_step: Callable[[int], None] | None = None,
    max_wall: float = 300.0,
    clock: Callable[[], float] = time.perf_counter,
) -> TraceResult:
    """Replay ``requests`` against ``engine`` in real time.

    ``on_step(step_idx)`` runs between decode steps (a test can publish
    checkpoints inline with it — single-threaded and deterministic);
    ``watcher`` is polled every ``poll_interval`` seconds of harness time.
    ``max_wall`` is a hard stop so an overloaded configuration ends with
    truncated completions rather than a hung harness.
    """
    pending = collections.deque(sorted(requests, key=lambda r: r.arrival))
    queue: collections.deque[Request] = collections.deque()
    completed: list[Request] = []
    steps: list[StepSample] = []
    t0 = clock()
    last_poll = -poll_interval
    latest_round = -1
    swaps0 = engine.swaps
    steps0 = engine.decode_steps
    dd0, ad0 = engine.decode_dispatches, engine.admit_dispatches
    step_idx = 0
    while pending or queue or engine.busy():
        now = clock() - t0
        if now > max_wall:
            break
        while pending and pending[0].arrival <= now:
            queue.append(pending.popleft())
        while queue and engine.free_slots():
            r = queue.popleft()
            if engine.admit(r, now=clock() - t0):
                completed.append(r)   # finished at admission
        if watcher is not None and now - last_poll >= poll_interval:
            engine.poll_watcher(watcher)
            got = watcher.latest_round()
            latest_round = got if got is not None else latest_round
            last_poll = now
        if engine.busy():
            n_active = engine.active_count()
            done = engine.step(now=clock() - t0)
            completed.extend(done)
            steps.append(StepSample(
                t=now, n_active=n_active, queue_depth=len(queue),
                serving_round=engine.serving_round,
                latest_round=latest_round,
            ))
            if on_step is not None:
                on_step(step_idx)
            step_idx += 1
        elif pending:
            # idle: nothing decodable until the next arrival
            time.sleep(min(max(pending[0].arrival - now, 0.0), 0.002))
    return TraceResult(
        completed=completed, steps=steps, wall=clock() - t0,
        swaps=engine.swaps - swaps0,
        decode_steps=engine.decode_steps - steps0,
        decode_dispatches=engine.decode_dispatches - dd0,
        admit_dispatches=engine.admit_dispatches - ad0,
    )

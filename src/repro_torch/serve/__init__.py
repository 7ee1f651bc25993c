"""repro_torch.serve — continuous-batching serving on the card, fed by
federation rounds.

  * ``ServeEngine`` (``engine``) — fixed-slot continuous batching over the
    dense decoder stack; one counted program call + one host sync per
    steady-state decode step;
  * ``CheckpointPublisher`` / ``CheckpointWatcher`` (``handoff``) — the
    training→serving channel: atomic per-round ``repro-ckpt-v1`` files in
    a watched directory, hot-swapped between decode steps without touching
    in-flight KV caches;
  * ``generate_requests`` / ``run_open_loop`` (``traffic``) + ``summarize``
    (``metrics``) — the seeded open-loop Poisson harness, the reference's
    schedule and row format.

``python -m repro_torch.serve`` runs one open-loop trace (see ``cli``);
``federation.train_and_publish`` wires the DeCaPH arm into the publish
side.
"""

from repro_torch.serve.engine import ServeConfig, ServeEngine, batch_generate
from repro_torch.serve.handoff import (
    CheckpointPublisher,
    CheckpointWatcher,
    checkpoint_path,
    list_rounds,
)
from repro_torch.serve.metrics import render_markdown, summarize
from repro_torch.serve.traffic import (
    Request,
    StepSample,
    TraceResult,
    TrafficConfig,
    generate_requests,
    run_open_loop,
)

__all__ = [
    "CheckpointPublisher",
    "CheckpointWatcher",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "StepSample",
    "TraceResult",
    "TrafficConfig",
    "batch_generate",
    "checkpoint_path",
    "generate_requests",
    "list_rounds",
    "render_markdown",
    "run_open_loop",
    "summarize",
]

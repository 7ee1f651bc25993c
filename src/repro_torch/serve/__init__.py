"""repro_torch.serve — continuous-batching serving on the card.

  * ``ServeEngine`` (``engine``) — fixed-slot continuous batching over the
    dense decoder stack; one counted program call + one host sync per
    steady-state decode step;
  * ``generate_requests`` / ``run_open_loop`` (``traffic``) + ``summarize``
    (``metrics``) — the seeded open-loop Poisson harness, the reference's
    schedule and row format.

``python -m repro_torch.serve`` runs one open-loop trace (see ``cli``).
"""

from repro_torch.serve.engine import ServeConfig, ServeEngine, batch_generate
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
    "Request",
    "ServeConfig",
    "ServeEngine",
    "StepSample",
    "TraceResult",
    "TrafficConfig",
    "batch_generate",
    "generate_requests",
    "render_markdown",
    "run_open_loop",
    "summarize",
]

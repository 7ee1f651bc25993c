"""repro_torch.scenarios — declarative scenario suite + cached parallel sweeps.

Counterpart of ``repro.scenarios``: the same specs, hashes, presets,
sweeps and reports, executed by the port on the device the caller names.

The paper's claims are comparative (DeCaPH vs FL vs PriMIA vs local across
three multi-hospital case studies); this package makes every comparison cell
a declarative, JSON-serialisable ``ScenarioSpec``, gives the named cells a
preset library (``presets``), expands axis products with ``SweepGrid``,
executes them through a content-addressed result cache with process-pool
parallelism (``run_sweep``), and fits wall-clock/bytes scaling laws into
``BENCH_torch_sweep.json`` + a markdown report (``report``).  See
DESIGN.md §6.

    from repro_torch.scenarios import ScenarioSpec, get_preset, get_sweep
    from repro_torch.scenarios import ResultCache, run_sweep, run_spec

    outcome = run_sweep(get_sweep("capacity-lm").specs(), ResultCache())
    row = run_spec(get_preset("gemini-small"), device="cpu")

CLI: ``python -m repro_torch.scenarios --list/--run/--sweep/--report``.
Importing this package loads no torch.
"""

from repro_torch.scenarios.cache import DEFAULT_CACHE_DIR, ResultCache
from repro_torch.scenarios.executor import (
    SweepOutcome,
    build_scenario,
    run_spec,
    run_sweep,
)
from repro_torch.scenarios.grid import SWEEPS, SweepGrid, get_sweep
from repro_torch.scenarios.presets import (
    FIVE_HOSPITAL_NODES,
    FIVE_HOSPITAL_TOPOLOGY,
    FIVE_HOSPITAL_TRACE,
    all_presets,
    get_preset,
)
from repro_torch.scenarios.report import (
    bench_payload,
    fit_power_law,
    markdown_report,
    scaling_laws,
    write_artifacts,
)
from repro_torch.scenarios.spec import ScenarioSpec

__all__ = [
    "DEFAULT_CACHE_DIR",
    "FIVE_HOSPITAL_NODES",
    "FIVE_HOSPITAL_TOPOLOGY",
    "FIVE_HOSPITAL_TRACE",
    "ResultCache",
    "SWEEPS",
    "ScenarioSpec",
    "SweepGrid",
    "SweepOutcome",
    "all_presets",
    "bench_payload",
    "build_scenario",
    "fit_power_law",
    "get_preset",
    "get_sweep",
    "markdown_report",
    "run_spec",
    "run_sweep",
    "scaling_laws",
    "write_artifacts",
]

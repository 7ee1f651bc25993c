"""Content-addressed on-disk cache for sweep cell results.

Counterpart of ``repro.scenarios.cache``.  The keys are the reference's
(``ScenarioSpec.spec_hash()``), so the port keeps its results in a
directory of its own, ``.sweep_cache_torch``: a shared directory would
serve the reference's results as the port's, or the other way round.

One JSON file per cell, named by ``ScenarioSpec.spec_hash()``.  Re-running a
sweep therefore only executes new/changed cells — a sweep interrupted at
cell 40/112 resumes where it left off, and editing one axis value only
invalidates the cells it touches.

Robustness contract (tested in ``tests/test_torch_scenarios.py``): a corrupted or
stale entry (unparseable JSON, schema mismatch, key/spec mismatch, missing
result fields) is treated as a miss — logged loudly, evicted, recomputed —
never an exception and never silently wrong data.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

from repro_torch.scenarios.spec import ScenarioSpec

logger = logging.getLogger(__name__)

CACHE_SCHEMA = 1
DEFAULT_CACHE_DIR = ".sweep_cache_torch"

# every field the report layer dereferences must be present, or the entry
# is treated as corrupted — served entries must never crash reporting
_REQUIRED_RESULT_KEYS = frozenset(
    {"name", "arm", "backend", "hospitals", "model_size", "model_params",
     "rounds_completed", "epsilon", "accuracy", "wall_clock",
     "bytes_on_wire", "recoveries"}
)


class ResultCache:
    """Spec-hash-addressed store of cell results."""

    def __init__(self, root: str | os.PathLike = DEFAULT_CACHE_DIR) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, spec: ScenarioSpec) -> Path:
        return self.root / f"{spec.spec_hash()}.json"

    def get(self, spec: ScenarioSpec) -> dict | None:
        """The cached result for ``spec``, or None (miss / evicted)."""
        path = self.path(spec)
        if not path.exists():
            return None
        try:
            entry = json.loads(path.read_text())
            if entry["schema"] != CACHE_SCHEMA:
                raise ValueError(f"schema {entry['schema']} != {CACHE_SCHEMA}")
            if entry["key"] != spec.spec_hash():
                raise ValueError("key does not match spec hash")
            result = entry["result"]
            missing = _REQUIRED_RESULT_KEYS - set(result)
            if missing:
                raise ValueError(f"result missing fields {sorted(missing)}")
        except (OSError, ValueError, KeyError, TypeError) as e:
            logger.warning(
                "corrupted cache entry %s for %s (%s); evicting and "
                "recomputing", path, spec.name or spec.spec_hash(), e,
            )
            try:
                path.unlink()
            except OSError:
                pass
            return None
        return result

    def put(self, spec: ScenarioSpec, result: dict) -> Path:
        """Atomically persist ``result`` under ``spec``'s hash."""
        path = self.path(spec)
        entry = {
            "schema": CACHE_SCHEMA,
            "key": spec.spec_hash(),
            "spec": spec.to_dict(),
            "result": result,
        }
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(entry, indent=2, sort_keys=True))
        os.replace(tmp, path)
        return path

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

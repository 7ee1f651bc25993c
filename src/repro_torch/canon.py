"""THE canonical-JSON content-hash discipline, in one place.

The port's own copy of ``repro.canon`` (same encoding, same hashes).

Every content-addressed artifact in the repo — ``population.graph`` node
ids and graph hashes (DESIGN.md §10), ``obs.ledger`` entry ids (§11),
``scenarios.spec`` cache keys (§6) — hashes the SAME byte encoding:
``json.dumps(obj, sort_keys=True, separators=(",", ":"))`` through
sha256.  Any site that spells its own ``json.dumps`` + ``hashlib``
combination can silently diverge (a stray ``indent=``, default
separators, unsorted keys) and fork the address space, so the encoding
lives here and the ``canonical-hash-discipline`` rule in
``repro.analysis`` (DESIGN.md §13) flags every hand-rolled copy.

Stdlib-only: the trace phase and the obs core must never pay the JAX
import.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

__all__ = ["canonical_json_bytes", "content_hash", "bytes_hash"]


def canonical_json_bytes(obj: Any) -> bytes:
    """The one canonical byte encoding content hashes are computed over."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def bytes_hash(raw: bytes, *, chars: int = 16) -> str:
    """sha256 hex digest of ``raw``, truncated to ``chars`` characters."""
    return hashlib.sha256(raw).hexdigest()[:chars]


def content_hash(obj: Any, *, chars: int = 16) -> str:
    """sha256 of the canonical JSON encoding of ``obj`` (first ``chars``)."""
    return bytes_hash(canonical_json_bytes(obj), chars=chars)

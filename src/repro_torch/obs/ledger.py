"""The per-hospital privacy ledger: an append-only, hash-chained audit log.

The port's own copy of ``repro.obs.ledger``: the same schema, chain and
hashes, so a ledger written by the port validates byte for byte like the
reference's.

DeCaPH's pitch is *auditable* collaboration — each hospital must be able
to show, after the fact, exactly what left its walls and what privacy
budget was spent doing so.  The ledger is that artifact: one record per
(accounted round, hospital), for EVERY hospital, not just the round's
cohort.  Under Poisson cohort subsampling a non-sampled hospital's data is
still covered by the round's composition step (the accountant composes at
the *marginal* inclusion rate ``q * p``), so its ε advances even in rounds
it sat out; the ``member``/``delivered`` flags record the participation
story separately from the accounting story.

Integrity discipline is the same content-hash chain ``population.graph``
uses for its Merkle compute graph: each entry's ``id`` is the sha256 of
its canonical JSON record — which includes ``prev``, the previous entry's
id — so the newest id pins the entire history.  Any in-place edit (a
doctored ε, a reordered round, a deleted entry) breaks either an id
recomputation or the prev chain, and ``validate_entries`` says which.

Stdlib-only, like the rest of the obs core.

Entry schema (JSONL, one object per line — DESIGN.md §11):

    {"seq", "prev", "id",                    # chain bookkeeping
     "kind": "round",
     "round", "hospital", "arm", "backend",
     "member", "delivered",                  # cohort membership / upload landed
     "eps", "delta",                         # cumulative (ε, δ) AFTER this round
     "sampling_rate", "participation_rate", "noise_multiplier",
     "bytes_up",                             # bytes that left this hospital
     "topup"}                                # DP noise top-up applied (shares
                                             # lost mid-round; DESIGN.md §10)
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterable, Mapping, Sequence

from repro_torch.canon import content_hash

GENESIS = "0" * 16

LEDGER_SCHEMA = 1


def entry_id(record: Mapping) -> str:
    """Content hash of one entry (minus its own ``id``) — graph.py style."""
    material = {k: v for k, v in record.items() if k != "id"}
    return content_hash(material)


class LedgerError(ValueError):
    """A ledger failed hash-chain or semantic validation."""


class PrivacyLedger:
    """Append-only, thread-safe, hash-chained privacy audit log."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: list[dict] = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def append(self, **fields) -> dict:
        """Append one entry; chain bookkeeping (seq/prev/id) is added here
        and only here, under the lock, so concurrent writers cannot fork
        the chain."""
        with self._lock:
            prev = self._entries[-1]["id"] if self._entries else GENESIS
            record = {"seq": len(self._entries), "prev": prev, **fields}
            record["id"] = entry_id(record)
            self._entries.append(record)
            return record

    def record_round(
        self,
        *,
        round: int,
        arm: str,
        backend: str,
        hospitals: int,
        cohort: Iterable[int],
        delivered: Iterable[int],
        epsilon: float,
        delta: float,
        sampling_rate: float,
        participation_rate: float,
        noise_multiplier: float,
        bytes_up: float,
        topup: bool = False,
    ) -> list[dict]:
        """One accounted round -> one entry per hospital (all H of them).

        ``epsilon`` is the accountant's cumulative ε AFTER this round's
        composition step; every hospital records it (aggregate-dataset DP:
        the guarantee is shared).  ``bytes_up`` is charged only to
        hospitals whose upload actually left (``delivered``).
        """
        cohort_set, delivered_set = set(cohort), set(delivered)
        out = []
        for i in range(hospitals):
            out.append(self.append(
                kind="round", round=round, hospital=i, arm=arm,
                backend=backend,
                member=i in cohort_set, delivered=i in delivered_set,
                eps=float(epsilon), delta=float(delta),
                sampling_rate=float(sampling_rate),
                participation_rate=float(participation_rate),
                noise_multiplier=float(noise_multiplier),
                bytes_up=float(bytes_up) if i in delivered_set else 0.0,
                topup=bool(topup),
            ))
        return out

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    # -- export ---------------------------------------------------------------

    def to_jsonl(self) -> str:
        header = json.dumps({"type": "ledger-meta", "schema": LEDGER_SCHEMA},
                            sort_keys=True)
        lines = [header] + [json.dumps(e, sort_keys=True)
                            for e in self.entries()]
        return "\n".join(lines) + "\n"

    def write_jsonl(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())


# -- reading / validation ------------------------------------------------------


def read_entries(path: str | os.PathLike) -> list[dict]:
    """Parse a ledger JSONL file (skipping the meta header line)."""
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise LedgerError(f"line {lineno}: not JSON: {e}") from e
            if rec.get("type") == "ledger-meta":
                continue
            out.append(rec)
    return out


def validate_entries(entries: Sequence[Mapping]) -> dict:
    """Full chain + semantic validation; returns a summary dict.

    Checks, in order, for each entry: ``seq`` is its position, ``prev``
    matches the previous entry's ``id`` (GENESIS for the first), the
    ``id`` recomputes from the record's own content, and per-hospital ε is
    non-decreasing (budgets are only ever spent).  Raises ``LedgerError``
    naming the first entry that fails.
    """
    eps_seen: dict[tuple[str, int], float] = {}
    prev = GENESIS
    for i, rec in enumerate(entries):
        if rec.get("seq") != i:
            raise LedgerError(f"entry {i}: seq {rec.get('seq')} != {i} "
                              "(reordered or deleted entries)")
        if rec.get("prev") != prev:
            raise LedgerError(f"entry {i}: prev {rec.get('prev')!r} breaks "
                              f"the chain (expected {prev!r})")
        if entry_id(rec) != rec.get("id"):
            raise LedgerError(f"entry {i}: content hash mismatch — the "
                              "record was modified after it was chained")
        if rec.get("kind") == "round":
            key = (rec.get("arm", ""), rec["hospital"])
            before = eps_seen.get(key, 0.0)
            if rec["eps"] < before - 1e-12:
                raise LedgerError(
                    f"entry {i}: hospital {rec['hospital']} ε decreased "
                    f"({before} -> {rec['eps']})")
            eps_seen[key] = rec["eps"]
        prev = rec["id"]
    return {
        "entries": len(entries),
        "hospitals": len({r["hospital"] for r in entries
                          if r.get("kind") == "round"}),
        "rounds": len({r["round"] for r in entries
                       if r.get("kind") == "round"}),
        "final_eps": per_hospital_epsilon(entries),
        "head": prev,
    }


def per_hospital_epsilon(entries: Sequence[Mapping]) -> dict[int, float]:
    """Cumulative ε per hospital: the last round entry's ε for each."""
    out: dict[int, float] = {}
    for rec in entries:
        if rec.get("kind") == "round":
            out[rec["hospital"]] = rec["eps"]
    return out


def bytes_by_hospital(entries: Sequence[Mapping]) -> dict[int, float]:
    """Total bytes each hospital shipped, per the ledger."""
    out: dict[int, float] = {}
    for rec in entries:
        if rec.get("kind") == "round":
            out[rec["hospital"]] = out.get(rec["hospital"], 0.0) \
                + rec.get("bytes_up", 0.0)
    return out

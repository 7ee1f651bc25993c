"""Secure Aggregation (Bonawitz et al. 2017 style) in fixed-point arithmetic.

Counterpart of ``repro.core.secagg`` for the honest-but-curious session.
DeCaPH uses SecAgg in three places (paper Methods): (1) global feature
mean/variance at preparation, (2) aggregate mini-batch size per round,
(3) the gradient aggregation itself:

  * values are quantised to a finite field Z_{2^32} (fixed point,
    ``frac_bits`` fractional bits),
  * every unordered pair (i < j) of participants shares a one-time pad from
    a pairwise PRG seed,
  * participant i uploads  x_i + sum_{j>i} PRG(s_ij) - sum_{j<i} PRG(s_ji)
    (mod 2^32); masks cancel *exactly* in the field sum, so the aggregator
    only ever learns the total.

Two session flavours, as in the reference:

  * ``SecAggSession`` — the paper's variant: hospitals follow the protocol
    and stay online, so every upload must arrive (``aggregate`` fails
    loudly otherwise — a missing upload would leave un-cancelled masks and
    a silently corrupt sum);
  * ``DropoutRobustSession`` — Bonawitz-style recovery: pairwise pads
    seeded by a (toy 61-bit) Diffie-Hellman agreement, each DH secret
    Shamir-shared among the cohort, so any ``threshold`` survivors let the
    facilitator rebuild a dropped party's pads and cancel them.  The
    simulated-time backend (``arms.runners.SimRunner``) runs it.

The field arithmetic runs on the host in numpy, as the reference's does:
uploads are ciphertexts, not device tensors, and numpy gives exact
64 -> 32-bit modular arithmetic (torch has no general uint32 arithmetic).
Only ``aggregate``'s decoded float32 totals go back to a device.

The PRG is the port's own: each unordered pair {lo, hi} draws its pad from
``np.random.Generator(np.random.Philox(SeedSequence((seed, lo, hi))))``,
and a dropout-robust pair from ``Philox(SeedSequence(agreement))``, where
the reference folds (lo, hi) or the agreement's words into a threefry key.
The ciphertexts therefore differ from the reference's; the masks still
cancel exactly, so sums and decoded totals are the reference's bit for
bit.  The DH secrets, public keys and Shamir shares come from the same
numpy generator as the reference's, so they are its own, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.tree import Tree, tree_leaves, tree_unflatten

_FIELD_DTYPE = np.uint32
_FIELD_BITS = 32


@dataclasses.dataclass(frozen=True)
class SecAggConfig:
    n_participants: int
    frac_bits: int = 16  # fixed-point fractional bits
    seed: int = 0
    # Accepted so that configs shaped like the reference's still build, and
    # ignored: the reference draws a chunk of pads in one vectorised call,
    # while here each pad is drawn and added on its own, so one pad is all
    # that is ever resident.
    pad_chunk_pairs: int = 1024

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)


def _encode(x, cfg: SecAggConfig) -> np.ndarray:
    """float -> field element (two's-complement embedding into uint32)."""
    q = np.round(np.asarray(x, np.float64) * cfg.scale).astype(np.int64)
    return (q % (1 << _FIELD_BITS)).astype(_FIELD_DTYPE)


def _decode(v: np.ndarray, cfg: SecAggConfig) -> np.ndarray:
    """field element -> float (centered: values >= 2^31 are negative)."""
    v = v.astype(np.int64)
    v = np.where(v >= (1 << (_FIELD_BITS - 1)), v - (1 << _FIELD_BITS), v)
    return (v.astype(np.float64) / cfg.scale).astype(np.float32)


# -- the pair pads, each drawn once per session (DESIGN.md §7) ----------------
#
# Each unordered pair {lo, hi} draws its pad exactly ONCE and adds it to
# the signed net masks at once (lo adds, hi subtracts — every pad appears
# once with each sign and cancels in the field sum), so one pad of L words
# is the only one resident.


def _pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Index arrays (los, his) over the n*(n-1)/2 unordered pairs, lo < hi."""
    lo, hi = np.triu_indices(n, k=1)
    return lo.astype(np.uint32), hi.astype(np.uint32)


def _pair_pad(seed: int, lo: int, hi: int, length: int) -> np.ndarray:
    """The one-time pad of pair {lo, hi}: ``length`` uniform field words."""
    gen = np.random.Generator(np.random.Philox(
        np.random.SeedSequence((int(seed), int(lo), int(hi)))))
    return gen.integers(0, 1 << _FIELD_BITS, size=length, dtype=_FIELD_DTYPE)


def _seed_pad(agreement: int, length: int) -> np.ndarray:
    """The one-time pad of a DH agreement (a 61-bit int): ``length`` field
    words.  The one derivation: the holders' masks and the facilitator's
    recovery draw the same words from the same agreement."""
    gen = np.random.Generator(np.random.Philox(
        np.random.SeedSequence(int(agreement))))
    return gen.integers(0, 1 << _FIELD_BITS, size=length, dtype=_FIELD_DTYPE)


def _signed_masks(n: int, length: int, los: np.ndarray, his: np.ndarray, *,
                  seed: int | None = None,
                  agreements: Sequence[int] | None = None) -> np.ndarray:
    """(n, L) net masks: row i = sum_{i=lo} pad - sum_{i=hi} pad (mod 2^32).
    Each pair's pad comes from ``_pair_pad(seed, lo, hi)``, or from
    ``_seed_pad`` of the pair's DH agreement when ``agreements`` is given."""
    masks = np.zeros((n, length), _FIELD_DTYPE)
    with np.errstate(over="ignore"):  # modular field arithmetic
        for k, (lo, hi) in enumerate(zip(los, his)):
            pad = (_pair_pad(seed, lo, hi, length) if agreements is None
                   else _seed_pad(agreements[k], length))
            masks[lo] += pad
            masks[hi] -= pad
    return masks


def _host(x) -> np.ndarray:
    """A leaf as a host array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten_encoded(leaves: Sequence[Any], template: Sequence[Any],
                     cfg: SecAggConfig) -> np.ndarray:
    """Encode every leaf and concatenate into one flat field vector."""
    out = []
    for li, (x, tmpl) in enumerate(zip(leaves, template)):
        shape = tuple(np.shape(tmpl))
        if tuple(np.shape(x)) != shape:
            raise ValueError(f"leaf {li} shape {tuple(np.shape(x))} != "
                             f"{shape}")
        out.append(_encode(_host(x), cfg).ravel())
    return np.concatenate(out) if out else np.zeros((0,), _FIELD_DTYPE)


def _split_flat(flat: np.ndarray, template: Sequence[Any]
                ) -> list[np.ndarray]:
    """Inverse of ``_flatten_encoded``: flat vector -> per-leaf arrays."""
    out, off = [], 0
    for leaf in template:
        shape = tuple(np.shape(leaf))
        # np.prod(()) == 1, so scalars count 1 and empty leaves count 0 —
        # matching exactly what _flatten_encoded ravels
        size = int(np.prod(shape))
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return out


def _stack_ciphertexts(uploads: Sequence[list[np.ndarray]]) -> np.ndarray:
    """(n_uploads, L) field matrix from per-leaf ciphertext lists."""
    return np.stack([
        np.concatenate([np.asarray(u).ravel() for u in up])
        for up in uploads
    ])


def _check_uploads(uploads: Sequence[list[np.ndarray]],
                   leaves: Sequence[Any]) -> None:
    """Fail loudly on short/misshapen ciphertexts (silent-garbage guard)."""
    for k, up in enumerate(uploads):
        if len(up) != len(leaves):
            raise ValueError(
                f"upload {k} has {len(up)} leaves, template has "
                f"{len(leaves)} — truncated or mis-structured ciphertext"
            )
        for li, (u, leaf) in enumerate(zip(up, leaves)):
            if tuple(np.shape(u)) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"upload {k} leaf {li} shape {np.shape(u)} != template "
                    f"shape {tuple(np.shape(leaf))}"
                )


def _template_device(leaves: Sequence[Any]) -> torch.device:
    """Where decoded totals go: the template's tensors' device, else the
    host (a numpy template is host data)."""
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _to_tensors(arrays: Sequence[np.ndarray], device) -> list[torch.Tensor]:
    """Decoded totals as float32 tensors on ``device`` (the copy back)."""
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


class _MaskedSession:
    """What both session flavours share: the template, the masked upload
    of one participant or of a whole cohort, and where decoded totals go.

    ``device`` is where ``aggregate`` puts the decoded totals (None: the
    template's tensors' device, or the host for a numpy template).
    """

    def __init__(self, cfg: SecAggConfig, template: Tree, *,
                 device=None) -> None:
        self.cfg = cfg
        self.template = template
        self._leaves = tree_leaves(template)
        self._length = int(sum(np.prod(np.shape(x)) for x in self._leaves))
        self.device = (_template_device(self._leaves) if device is None
                       else torch.device(device))
        self._los, self._his = _pairs(cfg.n_participants)
        self._masks: np.ndarray | None = None  # (n, L), built lazily

    def _flat_masks(self) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def mask_for(self, i: int) -> list[np.ndarray]:
        """Net mask participant i applies (sums to zero over participants)."""
        return _split_flat(self._flat_masks()[i], self._leaves)

    def _leaves_of(self, values: Tree) -> list:
        leaves = tree_leaves(values)
        if len(leaves) != len(self._leaves):
            raise ValueError("tree structure mismatch")
        return leaves

    def upload(self, i: int, values: Tree) -> list[np.ndarray]:
        """Masked ciphertext participant i sends to the leader."""
        leaves = self._leaves_of(values)
        with np.errstate(over="ignore"):  # modular wraparound is the protocol
            flat = _flatten_encoded(leaves, self._leaves, self.cfg)
            flat = flat + self._flat_masks()[i]
        return _split_flat(flat, self._leaves)

    def upload_all(self, values: Mapping[int, Tree]
                   ) -> dict[int, list[np.ndarray]]:
        """Ciphertexts for a whole cohort in one masking pass (participant
        index -> masked ciphertext); bit for bit per-participant
        ``upload`` calls (encode is elementwise, masks are the same rows)."""
        if not values:
            return {}
        order = sorted(values)
        cohort = [self._leaves_of(values[i]) for i in order]
        enc = np.stack([_flatten_encoded(leaves, self._leaves, self.cfg)
                        for leaves in cohort])
        with np.errstate(over="ignore"):  # modular field arithmetic
            enc += self._flat_masks()[np.asarray(order, np.intp)]
        return {i: _split_flat(row, self._leaves)
                for i, row in zip(order, enc)}

    def _decoded(self, total: np.ndarray) -> Tree:
        """The field total decoded into float32 tensors on ``self.device``."""
        decoded = [_decode(t, self.cfg)
                   for t in _split_flat(total, self._leaves)]
        return tree_unflatten(self.template,
                              _to_tensors(decoded, self.device))


class SecAggSession(_MaskedSession):
    """One aggregation round over a fixed template tree (every upload must
    arrive)."""

    def _flat_masks(self) -> np.ndarray:
        """Every participant's net mask, one pair's pad at a time."""
        if self._masks is None:
            self._masks = _signed_masks(
                self.cfg.n_participants, self._length, self._los, self._his,
                seed=self.cfg.seed,
            )
        return self._masks

    def aggregate(self, uploads: Sequence[list[np.ndarray]]) -> Tree:
        """Leader-side sum of ciphertexts; masks cancel exactly in Z_2^32.
        Returns the decoded total as float32 tensors on ``self.device``."""
        if len(uploads) != self.cfg.n_participants:
            raise ValueError(
                "honest-but-curious SecAgg requires all participants "
                f"({len(uploads)} of {self.cfg.n_participants} uploads); a "
                "missing upload leaves un-cancelled masks in the sum — use "
                "DropoutRobustSession if participants may drop out"
            )
        _check_uploads(uploads, self._leaves)
        with np.errstate(over="ignore"):  # modular wraparound is the protocol
            total = _stack_ciphertexts(uploads).sum(axis=0,
                                                    dtype=_FIELD_DTYPE)
        return self._decoded(total)


def secure_sum(values: Sequence[Tree], cfg: SecAggConfig, *,
               device=None) -> Tree:
    """Convenience: full round (upload + aggregate) over a list of trees;
    the total lands on ``device`` (see ``SecAggSession``)."""
    values = list(values)
    if not values:
        raise ValueError("secure_sum: empty value list")
    if len(values) != cfg.n_participants:
        raise ValueError(
            f"secure_sum: {len(values)} value trees for "
            f"{cfg.n_participants} participants — every participant must "
            "contribute (dropouts need DropoutRobustSession)"
        )
    session = SecAggSession(cfg, values[0], device=device)
    uploads = session.upload_all(dict(enumerate(values)))
    return session.aggregate([uploads[i] for i in range(len(values))])


def secure_sum_ints(values: Sequence[int], *, n_participants: int,
                    seed: int = 0) -> int:
    """Exact integer SecAgg sum — no float/fixed-point round-trip.

    Batch sizes (and any other small non-negative integer telemetry) embed
    directly into Z_2^32; the masked field sum is exact as long as the true
    total stays below 2^31 (it is validated).
    """
    values = [int(v) for v in values]
    if len(values) != n_participants:
        raise ValueError(
            f"secure_sum_ints: {len(values)} values for "
            f"{n_participants} participants — every participant must "
            "contribute"
        )
    if any(v < 0 for v in values):
        raise ValueError("secure_sum_ints: negative value")
    if sum(values) >= (1 << (_FIELD_BITS - 1)):
        raise ValueError("secure_sum_ints: total overflows the field")
    los, his = _pairs(n_participants)
    masks = _signed_masks(n_participants, 1, los, his, seed=seed)[:, 0]
    with np.errstate(over="ignore"):  # modular field arithmetic
        ciphertexts = np.asarray(values, np.uint64).astype(_FIELD_DTYPE) + masks
        total = int(ciphertexts.sum(dtype=_FIELD_DTYPE))
    return total


# --------------------------------------------------------------------------
# Dropout-robust SecAgg: DH pairwise seeds + Shamir recovery (Bonawitz §4).
# --------------------------------------------------------------------------

# 2^61 - 1 (Mersenne prime).  One field for both the Shamir shares and the
# toy Diffie-Hellman group, as in the reference: a deployment would use
# X25519; the protocol (what is shared, who reveals what, when) is what is
# reproduced.
_SHAMIR_PRIME = (1 << 61) - 1
_DH_GENERATOR = 3


def shamir_share(secret: int, n_shares: int, threshold: int,
                 rng: np.random.Generator) -> list[tuple[int, int]]:
    """Split ``secret`` into n points of a degree-(threshold-1) polynomial."""
    if not 0 <= secret < _SHAMIR_PRIME:
        raise ValueError("secret out of field range")
    if not 1 <= threshold <= n_shares:
        raise ValueError("need 1 <= threshold <= n_shares")
    coeffs = [secret] + [
        int(rng.integers(0, _SHAMIR_PRIME)) for _ in range(threshold - 1)
    ]
    shares = []
    for x in range(1, n_shares + 1):
        y = 0
        for c in reversed(coeffs):  # Horner
            y = (y * x + c) % _SHAMIR_PRIME
        shares.append((x, y))
    return shares


def shamir_reconstruct(shares: Sequence[tuple[int, int]]) -> int:
    """Lagrange-interpolate the polynomial at 0 from >= threshold shares."""
    if not shares:
        raise ValueError("no shares to reconstruct from")
    if len({x for x, _ in shares}) != len(shares):
        raise ValueError("duplicate share indices")
    p = _SHAMIR_PRIME
    secret = 0
    for i, (xi, yi) in enumerate(shares):
        num, den = 1, 1
        for j, (xj, _) in enumerate(shares):
            if i == j:
                continue
            num = num * (-xj) % p
            den = den * (xi - xj) % p
        secret = (secret + yi * num * pow(den, p - 2, p)) % p
    return secret


class DropoutRobustSession(_MaskedSession):
    """SecAgg round that survives participants dropping before upload.

    Setup (simulated in-process; each step is one protocol message):
      1. *advertise*: every participant i draws a DH secret u_i and
         publishes g^{u_i}; the pairwise pad seed is the agreement
         s_ij = g^{u_i u_j}, which neither the facilitator nor a third
         party can derive;
      2. *share keys*: i Shamir-shares u_i among all participants with a
         reconstruction ``threshold`` t (honest-majority default).

    On dropout of d (no upload received): ``threshold`` survivors reveal
    their shares of u_d, the facilitator reconstructs u_d, regenerates the
    pad s_dj of every survivor j one at a time, and cancels it from the
    ciphertext sum — which then equals the plain sum of the survivors'
    values.  As in the reference there are no self-masks, so an upload
    that arrived is never unmasked: a party dropping after its upload
    landed stays in the sum.
    """

    def __init__(self, cfg: SecAggConfig, template: Tree, *,
                 threshold: int | None = None, device=None) -> None:
        n = cfg.n_participants
        if n < 2:
            raise ValueError("need at least 2 participants")
        self.threshold = threshold if threshold is not None else n // 2 + 1
        if not 2 <= self.threshold <= n:
            raise ValueError(f"threshold {self.threshold} not in [2, {n}]")
        super().__init__(cfg, template, device=device)
        # one seeded stream for every party's local randomness, as the
        # reference draws it (so secrets and shares are its own)
        rng = np.random.default_rng(np.uint64(cfg.seed) ^ np.uint64(0x5ECA66))
        self._secret_keys = [
            int(rng.integers(2, _SHAMIR_PRIME - 1)) for _ in range(n)
        ]
        self.public_keys = [
            pow(_DH_GENERATOR, u, _SHAMIR_PRIME) for u in self._secret_keys
        ]
        # shares[i][j] = participant j's share of u_i (index x = j + 1)
        self._shares = [
            shamir_share(u, n, self.threshold, rng) for u in self._secret_keys
        ]
        # (survivors, the field vector cancelling their pads with the
        # dropped parties), once ``recover`` ran
        self._recovered: tuple[tuple[int, ...], np.ndarray] | None = None

    def _pair_seed(self, holder: int, other: int) -> int:
        """DH agreement: pow(pk_other, u_holder) == g^(u_i u_j), symmetric."""
        return pow(self.public_keys[other], self._secret_keys[holder],
                   _SHAMIR_PRIME)

    def _flat_masks(self) -> np.ndarray:
        """Every participant's net mask, one agreement's pad at a time."""
        if self._masks is None:
            agreements = [self._pair_seed(int(lo), int(hi))
                          for lo, hi in zip(self._los, self._his)]
            self._masks = _signed_masks(
                self.cfg.n_participants, self._length, self._los, self._his,
                agreements=agreements,
            )
        return self._masks

    def recovery_shares(self, dropped: int, survivors: Sequence[int]
                        ) -> list[tuple[int, int]]:
        """Shares of u_dropped that the survivors reveal to the facilitator."""
        return [self._shares[dropped][j] for j in survivors]

    def recover(self, survivors: Sequence[int]) -> np.ndarray:
        """The facilitator's recovery: from ``threshold`` survivors' shares
        reconstruct each dropped party's secret, regenerate every pad it
        shared with a survivor (one pad resident at a time) and return the
        field vector that cancels them from the survivors' ciphertext sum.
        Cached for the round, so a backend can run it apart (its own
        ``secagg.recover`` span) before ``aggregate`` applies it."""
        key = tuple(sorted(survivors))
        if self._recovered is not None and self._recovered[0] == key:
            return self._recovered[1]
        n = self.cfg.n_participants
        dropped = [d for d in range(n) if d not in set(key)]
        fix = np.zeros((self._length,), _FIELD_DTYPE)
        with np.errstate(over="ignore"):  # modular field arithmetic
            for d in dropped:
                # any ``threshold`` survivors' shares reconstruct u_d exactly
                u_d = shamir_reconstruct(
                    self.recovery_shares(d, key[: self.threshold]))
                # survivor j applied +pad if j < d else -pad: regenerate
                # each pad from the reconstructed secret and cancel it
                for j in key:
                    pad = _seed_pad(pow(self.public_keys[j], u_d,
                                        _SHAMIR_PRIME), self._length)
                    if j < d:
                        fix -= pad
                    else:
                        fix += pad
        self._recovered = (key, fix)
        return fix

    def aggregate(self, uploads: Mapping[int, list[np.ndarray]]) -> Tree:
        """Sum received ciphertexts; reconstruct + cancel dropped pads.

        ``uploads`` maps participant index -> ciphertext; participants
        absent from it are treated as dropped and recovered via Shamir
        (``recover``).  Raises if fewer than ``threshold`` uploads survive.
        Returns the decoded total as float32 tensors on ``self.device``.
        """
        n = self.cfg.n_participants
        survivors = sorted(uploads)
        if any(not 0 <= s < n for s in survivors):
            raise ValueError("upload index out of range")
        if len(survivors) < self.threshold:
            raise ValueError(
                f"only {len(survivors)} uploads for threshold "
                f"{self.threshold}: cannot reconstruct dropped masks"
            )
        _check_uploads([uploads[s] for s in survivors], self._leaves)
        with np.errstate(over="ignore"):  # modular field arithmetic
            total = _stack_ciphertexts(
                [uploads[s] for s in survivors]).sum(axis=0,
                                                     dtype=_FIELD_DTYPE)
            if len(survivors) < n:
                total += self.recover(survivors)
        return self._decoded(total)


def secure_sum_with_dropouts(values: Sequence[Tree | None], cfg: SecAggConfig,
                             *, threshold: int | None = None,
                             device=None) -> Tree:
    """Full dropout-robust round; ``None`` entries are dropped participants."""
    values = list(values)
    if len(values) != cfg.n_participants:
        raise ValueError(
            f"{len(values)} slots for {cfg.n_participants} participants"
        )
    template = next((v for v in values if v is not None), None)
    if template is None:
        raise ValueError("every participant dropped; nothing to aggregate")
    session = DropoutRobustSession(cfg, template, threshold=threshold,
                                   device=device)
    uploads = session.upload_all(
        {i: v for i, v in enumerate(values) if v is not None}
    )
    return session.aggregate(uploads)


def secagg_recovery_bytes(n_participants: int, n_dropped: int = 0
                          ) -> dict[str, float]:
    """Wire-cost model for the dropout-robust extension.

    Setup: each participant broadcasts an 8 B public key and sends one 16 B
    Shamir share (8 B y + index) to each peer.  Recovery: each survivor
    reveals one share per dropped participant to the facilitator.
    """
    n, d = n_participants, n_dropped
    setup = n * 8.0 + n * (n - 1) * 16.0
    recovery = (n - d) * d * 16.0
    return {"setup_bytes": setup, "recovery_bytes": recovery}


def secagg_message_bytes(n_params: int, n_participants: int,
                         frac_bits: int = 16) -> dict[str, float]:
    """Communication-cost model for Supp. Table 1 (bytes per round).

    Per participant: one masked vector (4 B/elem in Z_2^32) plus the pairwise
    seed exchange (32 B per peer).  The aggregator receives all uploads.
    """
    per_participant = 4.0 * n_params + 32.0 * (n_participants - 1)
    aggregator = per_participant * n_participants
    plain = 4.0 * n_params
    return {
        "per_participant_bytes": per_participant,
        "aggregator_bytes": aggregator,
        "plain_per_participant_bytes": plain,
        "plain_aggregator_bytes": plain * n_participants,
    }

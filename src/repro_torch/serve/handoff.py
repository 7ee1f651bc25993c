"""Checkpoint handoff: training publishes rounds, serving hot-swaps them.

Counterpart of ``repro.serve.handoff``.  The channel is a watched
directory of ``repro-ckpt-v1`` files named ``ckpt-<round>.msgpack``
(``repro_torch.checkpoint``, byte for byte the reference's files).  The
writer side (``CheckpointPublisher``) is a round-end hook: ``repro_torch.
arms.run(..., on_round=publisher.publish)``.  It writes the port's
parameters in the reference's pytree layout (``convert.params_to_tree``,
every leaf in its own dtype), so the reference's watcher and serving
engine load the port's rounds, and the port's load the reference's.  The
reader side (``CheckpointWatcher``) polls for the newest round it has not
yet served and loads it.

No locking anywhere: ``save_checkpoint`` renames a complete temp file into
place, so the watcher either sees the old directory listing or a complete
new file.  A file that is nonetheless broken (a torn copy, a crashed
non-atomic writer), or pruned between the listing and the read, is skipped
with a warning and not marked seen, so the next poll retries.

Staleness is tracked in *rounds behind*: ``latest_round - serving_round``,
sampled by ``serve.traffic.run_open_loop`` at every decode step.
"""

from __future__ import annotations

import logging
import os
import re
import time

from repro_torch.checkpoint import (
    CorruptCheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.convert import params_to_tree

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt-(\d{8})\.msgpack$")


def checkpoint_path(root: str, round_idx: int) -> str:
    return os.path.join(root, f"ckpt-{round_idx:08d}.msgpack")


def list_rounds(root: str) -> list[int]:
    """Published round indices in ``root``, ascending."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    rounds = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            rounds.append(int(m.group(1)))
    return sorted(rounds)


class CheckpointPublisher:
    """Round-end publish hook: snapshot params into the watched directory.

    ``publish(round_idx, params)`` matches the ``on_round`` callback of
    ``repro_torch.arms.run``; ``params`` is the port's parameter dict (on
    any device).  ``keep_last`` bounds disk usage (old rounds are pruned
    after each publish; the newest always survives).
    """

    def __init__(self, root: str, *, keep_last: int | None = None,
                 metadata: dict | None = None) -> None:
        self.root = root
        self.keep_last = keep_last
        self.metadata = dict(metadata or {})
        self.published: list[int] = []
        os.makedirs(root, exist_ok=True)

    def publish(self, round_idx: int, params: dict) -> str:
        path = checkpoint_path(self.root, round_idx)
        meta = dict(self.metadata)
        meta["published_unix"] = time.time()
        save_checkpoint(path, params_to_tree(params), step=round_idx,
                        metadata=meta)
        self.published.append(round_idx)
        if self.keep_last is not None:
            for old in list_rounds(self.root)[: -self.keep_last]:
                try:
                    os.unlink(checkpoint_path(self.root, old))
                except OSError:
                    pass
        return path


class CheckpointWatcher:
    """Reader side: poll the directory, surface the newest unseen round.

    ``poll()`` returns ``(tree, round_idx, metadata)`` when a round newer
    than everything previously returned is fully readable, else ``None``.
    The tree is in the reference's layout with CPU tensor leaves in the
    file's dtypes; ``ServeEngine.poll_watcher`` carries it to the port's
    layout on the engine's device.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        self.seen_round = -1

    def latest_round(self) -> int | None:
        """Newest *published* round (cheap: one directory listing)."""
        rounds = list_rounds(self.root)
        return rounds[-1] if rounds else None

    def poll(self) -> tuple[dict, int, dict] | None:
        latest = self.latest_round()
        if latest is None or latest <= self.seen_round:
            return None
        try:
            tree, step, meta = load_checkpoint(
                checkpoint_path(self.root, latest)
            )
        except (CorruptCheckpointError, FileNotFoundError) as e:
            # skip-and-retry: a broken (or just-pruned) file must never
            # take serving down; the next publish supersedes it anyway
            logger.warning("watcher: skipping round %d: %s", latest, e)
            return None
        self.seen_round = latest
        return tree, step, meta

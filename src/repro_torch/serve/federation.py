"""Federation → serving glue: train a transformer arm, publish rounds.

Counterpart of ``repro.serve.federation``:

  * ``transformer_model`` — the dense decoder stack as an ``arms.Model``;
  * ``token_silos`` — synthetic per-hospital next-token corpora (each silo
    draws from its own biased token distribution);
  * ``train_and_publish`` — ``arms.run(...)`` with a
    ``CheckpointPublisher.publish`` wired to ``on_round``, so a watcher on
    the publish directory sees round-N params the moment round N commits.

SecAgg stays off here, as in the reference: the handoff is what this
exercises.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

import repro_torch.arms as arms
from repro_torch.arms.base import Model, Participant
from repro_torch.arms.clipping import GhostCapability
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.handoff import CheckpointPublisher

__all__ = ["transformer_model", "token_silos", "train_and_publish"]


def transformer_model(model_cfg, *, ghost_chunk: int | None = None,
                      device="cuda") -> Model:
    """The transformer stack as an ``arms.Model`` (per-example loss).

    ``init_fn(seed)`` builds seeded parameters on ``device`` (CUDA unless
    the caller asks for the CPU).  ``loss_fn(params, ex)`` takes one
    example ``ex = {"x": [S] tokens, "y": [S] shifted labels (-1 =
    masked)}``.  ``predict_fn(params, x)`` is the argmax at the last
    position of a full-sequence forward, run under ``torch.no_grad()``;
    with ``model_cfg.use_flash`` its causal attention runs the
    ``flash_attention`` kernel on the card.  Dense decoder stacks with
    untied embeddings also declare the ghost-clipping capability
    (DESIGN.md §12): DP arms then compute their clipped gradient sums
    through ``core.ghost`` (the ``ghost_norm`` kernel on the card), in
    chunks of ``ghost_chunk`` rows (None: the whole silo batch at once),
    which bounds the ghost path's residual-activation memory.
    """
    tf.check_supported(model_cfg)
    dev = resolve_device(device)

    def init_fn(seed: int):
        return tf.init(model_cfg, seed, dev)

    def loss_fn(params, ex):
        return tf.loss_fn(model_cfg, params, {"tokens": ex["x"][None],
                                              "labels": ex["y"][None]})

    @torch.no_grad()
    def predict_fn(params, x):
        logits, _ = tf.forward(model_cfg, params, {"tokens": x})
        return torch.argmax(logits[:, -1], dim=-1)

    # tied heads make the ghost head term an upper bound, not exact: those
    # configs stay on the faithful per-example path
    cap = (None if model_cfg.tie_embeddings
           else GhostCapability(model_cfg, chunk_size=ghost_chunk))
    return Model(init_fn, loss_fn, predict_fn, ghost=cap)


def token_silos(
    model_cfg,
    *,
    hospitals: int,
    n_per: int,
    seq_len: int,
    seed: int = 0,
    skew: float = 2.0,
) -> list[Participant]:
    """Synthetic non-IID next-token shards, one per hospital (the
    reference's draws, number for number).

    Each silo samples from its own Zipf-tilted token distribution (silo h
    permutes the vocab differently, ``skew`` controls how peaked).  Labels
    are inputs shifted left with the final position masked (``-1``).
    """
    rng = np.random.default_rng(seed)
    vocab = model_cfg.vocab_size
    base = 1.0 / np.arange(1, vocab + 1) ** skew
    silos = []
    for _ in range(hospitals):
        perm = rng.permutation(vocab)
        probs = base[perm] / base.sum()
        x = rng.choice(vocab, size=(n_per, seq_len), p=probs).astype(np.int32)
        y = np.full_like(x, -1)
        y[:, :-1] = x[:, 1:]
        silos.append(Participant(x, y))
    return silos


def train_and_publish(
    arm: str,
    model_cfg,
    publish_dir: str,
    *,
    rounds: int,
    hospitals: int = 4,
    n_per: int = 32,
    seq_len: int = 16,
    batch_size: int = 16,
    lr: float = 0.05,
    seed: int = 0,
    backend: str = "ideal",
    keep_last: int | None = None,
    pace_s: float = 0.0,
    silos: Sequence[Participant] | None = None,
    device="cuda",
    **run_kwargs,
):
    """Run ``arm`` on ``backend`` on ``device`` and publish every completed
    round.

    Returns ``(report, publisher)``; ``publisher.published`` lists the
    published round indices in order.  A ``CheckpointWatcher`` pointed at
    ``publish_dir`` picks each one up on its next poll.  ``pace_s`` sleeps
    after each publish, standing in for the real cross-hospital round
    cadence so a concurrent serving tier observes consecutive rounds.
    """
    model = transformer_model(model_cfg, device=device)
    if silos is None:
        silos = token_silos(model_cfg, hospitals=hospitals, n_per=n_per,
                            seq_len=seq_len, seed=seed)
    publisher = CheckpointPublisher(
        publish_dir, keep_last=keep_last,
        metadata={"arm": arm, "arch": model_cfg.name},
    )
    cfg = arms.ArmConfig(
        rounds=rounds, batch_size=batch_size, lr=lr, seed=seed,
        use_secagg=False,
    )
    on_round = publisher.publish
    if pace_s > 0:
        def on_round(t, params):  # noqa: F811 — paced variant
            publisher.publish(t, params)
            time.sleep(pace_s)
    report = arms.run(arm, model, list(silos), cfg, backend=backend,
                      on_round=on_round, **run_kwargs)
    return report, publisher

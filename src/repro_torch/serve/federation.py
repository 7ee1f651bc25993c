"""Federation glue: the transformer stack as an ``arms.Model``, and
synthetic per-hospital token corpora.

Counterpart of ``transformer_model`` and ``token_silos`` in
``repro.serve.federation``.  ``train_and_publish`` (training that feeds
the serving tier through checkpoints) waits for the port's checkpoints
(ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.arms.base import Model, Participant
from repro_torch.arms.clipping import GhostCapability
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf

__all__ = ["transformer_model", "token_silos"]


def transformer_model(model_cfg, *, device="cuda") -> Model:
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
    through ``core.ghost`` (the ``ghost_norm`` kernel on the card), one
    silo batch in one chunk.
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
    cap = None if model_cfg.tie_embeddings else GhostCapability(model_cfg)
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

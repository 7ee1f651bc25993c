"""Kind ``eval``: the federation scoring held-out notes with the port's
``use_flash`` forward, ``repro_torch.models.transformer.loss_fn`` under
``torch.no_grad()`` (causal attention through the ``flash_attention``
kernel), in the weights' bf16.

Set-up makes a held-out pool from the seed (``n_per`` sequences of each
hospital's distribution; each half of a batch is one hospital's) and the
weights, and scores ``warmup_batches`` batches.
The window scores batches of ``batch_size`` rows, cycling over the pool;
each ends in the one host sync that reads its loss.  After the window the
plain reference scores each distinct batch, and every loss the window
produced is compared with its batch's.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import generate
from perfbench.harness.port import model_config
from perfbench.harness.trace import Trace


def pool(mc: dict, mix: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The held-out rows in blocks of half a batch, hospital after hospital,
    so that each half of a batch holds another hospital's notes."""
    silos = generate.token_silos(
        mc["vocab_size"], hospitals=mix["hospitals"], n_per=mix["n_per"],
        seq_len=mix["seq_len"], skew=mix["skew"],
        seed=generate.substream(seed, generate.HELD_OUT_STREAM))
    block, s = mix["batch_size"] // 2, mix["seq_len"]

    def order(arrays):
        a = np.stack(arrays)                   # [hospitals, n_per, S]
        a = a.reshape(len(arrays), -1, block, s).transpose(1, 0, 2, 3)
        return np.ascontiguousarray(a.reshape(-1, s))
    return order([x for x, _ in silos]), order([y for _, y in silos])


def run(job) -> dict:
    from repro_torch.models import transformer as tf

    mc, mix, dev = {**job.mc, "use_flash": True}, job.mix, \
        torch.device(job.device)
    cfg = model_config(mc)
    x, y = pool(mc, mix, job.seed)
    bs = mix["batch_size"]
    batches = [{"tokens": torch.from_numpy(x[i:i + bs]).to(dev),
                "labels": torch.from_numpy(y[i:i + bs]).to(dev)}
               for i in range(0, len(x), bs)]
    params = generate.make_params(mc, job.seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def score(j: int) -> float:
        with torch.no_grad():
            return float(tf.loss_fn(cfg, params, batches[j]))

    for j in range(mix["warmup_batches"]):
        score(j % len(batches))
    length = min(job.seconds, mix["trace_seconds"]) if job.trace \
        else job.seconds
    tracer = Trace() if job.trace else None
    if tracer is not None:
        tracer.start()
    scored: list[tuple[int, float]] = []
    start = time.perf_counter()
    while True:
        j = len(scored) % len(batches)
        scored.append((j, score(j)))
        end = time.perf_counter()
        if end - start >= length:
            break
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window_s = end - start
    tokens = len(scored) * bs * mix["seq_len"]
    out = {
        "setup_s": start - job.t_start,
        "attempted": len(scored),
        "failed": sum(not math.isfinite(v) for _, v in scored),
        "memory_peak_bytes": peak,
        "end_to_end": {"eval_tokens_per_s": tokens / window_s},
        "ctx": {"mc": mc, "mix": mix, "window_s": window_s,
                "batches": len(scored), "tokens": tokens,
                "seq_len": mix["seq_len"], "batch_size": bs,
                "trace": tracer.summary if tracer else None},
        "notes": [f"window: {len(scored)} batches of {bs} x "
                  f"{mix['seq_len']} tokens, {window_s:.6f} s"],
    }
    ref = job.reference.batch_losses(mc, params, batches)
    prog = [v for _, v in scored]
    out["numbers"] = {"loss_gap": max(abs(v - ref[j]) / abs(ref[j])
                                      for j, v in scored)}
    out["readings"] = {"program": prog[:len(batches)], "reference": ref}
    out["variants"] = {}
    if "fp8" in job.variants:
        ctl = job.reference.batch_losses(mc, params, batches,
                                         mm=job.reference.plain.fp8_mm)
        out["variants"]["fp8"] = {"loss_gap": max(
            abs(c - r) / abs(r) for c, r in zip(ctl, ref))}
    return out

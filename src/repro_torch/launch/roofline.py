"""Roofline arithmetic on the NVIDIA H100, and a program's counted work.

Counterpart of ``repro.launch.roofline``.  The arithmetic is the
reference's, unchanged: ``roofline_terms``, ``model_flops``,
``ghost_norm_flops``, ``_ghost_collector_sites``, ``dp_round_flops`` and
``dp_round_roofline``.  Only the hardware constants are the card's
instead of a TPU v5e's.

The reference's ``HLOAnalyzer`` and ``analyze_compiled`` read XLA's
optimized HLO, which a PyTorch program does not have.  In their place
``analyze_program(fn, *args)`` runs the program once and counts its
floating-point operations by op with
``torch.utils.flop_counter.FlopCounterMode``, and reads the card's peak
memory over the call.  The counter sees ATen ops only: the hand-written
kernels, launched through ``ctypes``, are invisible to it.  The Grams of
``ghost_norm`` are therefore never read from the counter; they are
``ghost_norm_flops`` at each of ``_ghost_collector_sites`` (and on the
CPU, where the plain ghost norm runs as ATen ops, the counter includes
the plain version's products instead).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import active_param_count

# NVIDIA H100 SXM5 data sheet, at the 700 W power limit:
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s (no sparsity)
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s per direction (900 GB/s both)


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def roofline_terms(
    *, flops: float, hbm_bytes: float, coll_bytes: float, n_chips: int
) -> dict[str, float]:
    compute_t = flops / (n_chips * PEAK_FLOPS)
    memory_t = hbm_bytes / (n_chips * HBM_BW)
    coll_t = coll_bytes / (n_chips * LINK_BW)
    terms = {"compute_s": compute_t, "memory_s": memory_t, "collective_s": coll_t}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms


def model_flops(cfg, shape: dict, kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active per token (decode)."""
    n_active = active_param_count(cfg)
    b, s = shape["global_batch"], shape["seq_len"]
    if kind == "train":
        return 6.0 * n_active * b * s
    if kind == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b  # one token per sequence


def ghost_norm_flops(b: int, s: int, d_in: int, d_out: int) -> float:
    """FLOPs of one ghost-norm collector site ``||A^T G||_F^2`` per example.

    The Gram identity costs two [B,S,S] batched matmuls (2·B·S²·d each)
    plus the elementwise product-reduce (2·B·S²) — what the plain version
    and the reference's Pallas kernel execute, tile by tile.  (The card's
    kernel takes each pair of 64-row tiles once, on and below the
    diagonal, about half of these products; the count is the reference's.)
    """
    return float(b) * s * s * (2.0 * (d_in + d_out) + 2.0)


def _ghost_collector_sites(cfg) -> list[tuple[int, int]]:
    """(d_in, d_out) of every per-layer dense collector site + the head."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = [
        (d, cfg.n_heads * hd),            # wq
        (d, cfg.n_kv_heads * hd),         # wk
        (d, cfg.n_kv_heads * hd),         # wv
        (cfg.n_heads * hd, d),            # wo
        (d, cfg.d_ff),                    # w_up
        (cfg.d_ff, d),                    # w_down
    ]
    if cfg.ffn_kind in ("swiglu", "geglu"):
        per_layer.append((d, cfg.d_ff))   # w_gate
    return per_layer * cfg.n_layers + [(d, cfg.vocab_size)]  # + head


def dp_round_flops(cfg, *, cohort: int, batch_per_silo: int, seq_len: int,
                   clipping: str = "ghost") -> float:
    """Analytic FLOPs of one fused DP round over the cohort.

    Faithful per-example clipping is one fwd+bwd per example (6·N·tokens
    total — its cost problem is the per-example gradient *memory traffic*,
    not FLOPs).  The ghost path runs TWO batched passes (norms, then the
    factor-weighted grad: 12·N·tokens) plus the ghost-norm Gram
    contractions at every collector site — more arithmetic, no per-example
    gradients: ghost moves the round from the memory roof toward the
    compute roof.
    """
    n_active = active_param_count(cfg)
    tokens = float(cohort) * batch_per_silo * seq_len
    if clipping != "ghost":
        return 6.0 * n_active * tokens
    collector = sum(
        ghost_norm_flops(cohort * batch_per_silo, seq_len, di, do)
        for di, do in _ghost_collector_sites(cfg)
    )
    return 12.0 * n_active * tokens + collector


def dp_round_roofline(cfg, *, cohort: int, batch_per_silo: int,
                      seq_len: int, wall_seconds: float | None = None,
                      clipping: str = "ghost", n_chips: int = 1) -> dict:
    """%-of-roofline terms for one measured fused DP round.

    ``pct_of_roofline`` is the analytic round FLOPs over the measured wall
    clock, as a percentage of ``n_chips`` worth of the H100's bf16 peak.
    ``per_example_grad_bytes`` is the faithful path's per-example gradient
    materialisation floor (read+write), the traffic the ghost path
    deletes.
    """
    flops = dp_round_flops(cfg, cohort=cohort, batch_per_silo=batch_per_silo,
                           seq_len=seq_len, clipping=clipping)
    n_active = active_param_count(cfg)
    # HBM floor: one param read + one grad-sum write for either path (8N);
    # the faithful path additionally writes then re-reads one full gradient
    # per example (8NB) — the traffic the ghost path deletes.
    grad_bytes = (0.0 if clipping == "ghost"
                  else 2.0 * 4.0 * n_active * cohort * batch_per_silo)
    hbm_bytes = 2.0 * 4.0 * n_active + grad_bytes
    terms = roofline_terms(flops=flops, hbm_bytes=hbm_bytes,
                           coll_bytes=0.0, n_chips=n_chips)
    out = {
        "round_flops": flops,
        "per_example_grad_bytes": grad_bytes,
        "roofline_round_s": max(terms["compute_s"], terms["memory_s"]),
        "roofline_bottleneck": terms["bottleneck"],
        "clipping": clipping,
    }
    if wall_seconds is not None:
        achieved = flops / max(wall_seconds, 1e-12)
        out["achieved_flops_per_s"] = achieved
        out["pct_of_roofline"] = 100.0 * achieved / (n_chips * PEAK_FLOPS)
    return out


# ---------------------------------------------------------------------------
# A program's counted work
# ---------------------------------------------------------------------------

def _device_of(obj) -> torch.device | None:
    """The device of the first tensor in nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    items = obj.values() if isinstance(obj, dict) else \
        obj if isinstance(obj, (list, tuple)) else ()
    return next((d for d in map(_device_of, items) if d is not None), None)


def analyze_program(fn: Callable, *args) -> dict[str, Any]:
    """Run ``fn(*args)`` once; count its FLOPs by op and its peak memory.

    Returns ``flops`` (the total ``FlopCounterMode`` counted, forward and
    backward ATen ops alike, none of the ``ctypes`` kernels),
    ``flops_by_op`` (op name -> FLOPs, largest first), ``device`` and
    ``peak_memory_bytes``: ``torch.cuda.max_memory_allocated`` over the
    call on the card, None on the CPU.  ``out`` is ``fn``'s result.
    """
    device = _device_of(args) or torch.device("cpu")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    by_op = Counter({str(op): n for op, n in
                     counter.get_flop_counts()["Global"].items()})
    return {"flops": float(counter.get_total_flops()),
            "flops_by_op": dict(by_op.most_common()),
            "device": str(device), "peak_memory_bytes": peak, "out": out}

#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports only ``repro_torch`` (from ``src/``), ``torch``, ``numpy`` and the
standard library, and runs these phases in order; any failure raises and the
script exits non-zero, printing no result:

  1. card    — the card's name and power limit from ``nvidia-smi``;
  2. build   — ``nvcc`` builds every kernel of the serving path from
     ``src/repro_torch/csrc`` (one process per source, all at once);
  3. kernel vs plain — each kernel against its plain PyTorch version on
     the card, at the shapes of ``tests/test_kernels.py``, the serving shape
     and a long cache, in bfloat16 and float32, with per-row indices that
     include 0 and L-1;
  4. main path — ``ServeEngine`` serves SmolLM-360M at full width in
     bfloat16 (seeded random weights) over a seeded open-loop trace; every
     request must complete, and the kernel's launch count must equal
     n_layers x (decode steps + prefill positions);
  5. whole path — at full width in float32, ``decode_kernel=True`` against
     ``decode_kernel=False`` (the model's plain attention): the same greedy
     tokens, logits within atol 1e-3;
  6. times — each kernel, its plain version and one PyTorch library call
     (a yardstick the port never calls) on CUDA events, beside the least
     time the card could take.

The next-to-last line is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.instrument import jit_dispatches, reset_jit_dispatches  # noqa: E402
from repro_torch.kernels import KERNEL_SOURCES, _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine, batch_generate  # noqa: E402
from repro_torch.serve.metrics import summarize  # noqa: E402
from repro_torch.serve.traffic import TrafficConfig, generate_requests, run_open_loop  # noqa: E402

ARCH = "smollm-360m"
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# the serving shape: 8 slots of SmolLM-360M (15 query heads on 5 KV heads of
# 64) with 512 cache rows each, and the same at a long cache
SERVE_SHAPE = dict(b=8, l=512, h=15, kv=5, d=64)
LONG_SHAPE = dict(b=8, l=4096, h=15, kv=5, d=64)

# (b, l, h, kv, d, index, window): the decode shapes of tests/test_kernels.py,
# the serving shape, the long cache and a windowed MQA case at serving width
KERNEL_CASES = [
    (2, 256, 4, 2, 32, 100, None),
    (1, 512, 8, 8, 64, 511, None),
    (2, 256, 4, 1, 32, 200, 64),
    (1, 1024, 4, 4, 128, 0, None),
    (8, 512, 15, 5, 64, None, None),
    (8, 4096, 15, 5, 64, None, None),
    (8, 512, 15, 1, 64, None, 128),
]

# one entry per kernel on the serving path
KERNELS = [{
    "name": "decode_attention",
    "route": "cuda",
    "source": "src/repro_torch/csrc/decode_attention.cu",
    "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
}]


def say(*parts) -> None:
    print(*parts, flush=True)


# -- 1. card --------------------------------------------------------------------


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    say(line)
    return line


# -- 2. build -------------------------------------------------------------------


def build() -> None:
    spent = _build.build(KERNEL_SOURCES)
    say(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} -> "
        f"{', '.join(_build.library_path(n).name for n in KERNEL_SOURCES)} "
        f"in {spent:.2f} s")


# -- 3. kernel against its plain version ----------------------------------------


def _decode_inputs(b, l, h, kv, d, dtype, rows, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (0.5 * torch.randn((b, 1, h, d), generator=g, device=dev)).to(dtype)
    k = (0.5 * torch.randn((b, l, kv, d), generator=g, device=dev)).to(dtype)
    v = torch.randn((b, l, kv, d), generator=g, device=dev).to(dtype)
    index = torch.tensor(rows, dtype=torch.int32, device=dev)
    return q, k, v, index


def _case_rows(b, l, index, seed) -> list[int]:
    """Per-row indices: the case's own index on every row, or seeded draws,
    then a row at 0 and one at L-1 (the batch grows by two)."""
    if index is None:
        rows = np.random.default_rng(seed).integers(0, l, b).tolist()
    else:
        rows = [index] * b
        if b > 1:
            rows[1] = index // 2
    return rows + [0, l - 1]


def kernel_vs_plain(dev) -> float:
    """Every case in both dtypes; returns the largest |kernel - plain|."""
    worst = 0.0
    for i, (b, l, h, kv, d, index, window) in enumerate(KERNEL_CASES):
        rows = _case_rows(b, l, index, seed=i)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, idx = _decode_inputs(len(rows), l, h, kv, d, dtype, rows,
                                          seed=i, dev=dev)
            out = decode_ops.decode_attention(q, k, v, idx, window=window)
            ref = decode_attention_plain(q, k, v, idx, window=window)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"kernel output {tuple(out.shape)} "
                                     f"{out.dtype}, expected {tuple(ref.shape)}")
            err = float((out.float() - ref.float()).abs().max())
            ok = math.isfinite(err) and err <= TOL[dtype]
            say(f"kernel vs plain: B={len(rows)} L={l} H={h} KV={kv} D={d} "
                f"window={window} {str(dtype)[6:]}: max|err| {err:.3e} "
                f"(tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("decode_attention disagrees with its "
                                     "plain version")
            worst = max(worst, err)
    return worst


# -- 4. the main path -----------------------------------------------------------


def main_path(dev, smi: str):
    """Serve a seeded open-loop trace at full width; returns the engine and
    each kernel's launches in that run."""
    engine = ServeEngine(ServeConfig(
        arch=ARCH, smoke=False, slots=8, max_len=512, temperature=1.0,
        seed=SEED, device=str(dev)))
    mcfg = engine.model_cfg
    vocab = mcfg.vocab_size
    # warm-up (allocator, cuBLAS handles), outside the counted run
    batch_generate(engine, np.arange(1, 9, dtype=np.int32)[None], 2)
    requests = generate_requests(TrafficConfig(rate=16, n_requests=16,
                                               vocab_size=vocab, seed=SEED))
    prefill_positions = sum(len(r.prompt) for r in requests)

    decode_ops.reset_launches()
    reset_jit_dispatches()
    result = run_open_loop(engine, requests)
    launches = decode_ops.launches()
    calls = jit_dispatches()

    done = sorted(result.completed, key=lambda r: r.rid)
    if [r.rid for r in done] != [r.rid for r in requests]:
        raise AssertionError(f"{len(done)} of {len(requests)} requests "
                             "completed")
    short = [r.rid for r in done if len(r.tokens) != r.max_new_tokens]
    if short:
        raise AssertionError(f"requests {short} ended short of their budget")
    if not all(0 <= t < vocab for r in done for t in r.tokens):
        raise AssertionError("a sampled token lies outside the vocabulary")
    steps = result.decode_steps
    if result.decode_dispatches != steps or calls != steps + 2 * len(done):
        raise AssertionError(f"program calls {calls} (decode "
                             f"{result.decode_dispatches}) for {steps} decode "
                             f"steps and {len(done)} admissions")
    positions = steps + prefill_positions
    if launches != mcfg.n_layers * positions:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {mcfg.n_layers} x ({steps} decode "
                             f"steps + {prefill_positions} prefill positions)")
    row = summarize(result, slots=8, rate=16)
    say(f"main path: {ARCH} full width {str(mcfg.cdtype)[6:]}, 8 slots x 512,"
        f" 16 requests @ 16 q/s on {smi}: {row['throughput_tok_s']} tok/s, "
        f"TTFT p50/p99 {row['ttft_p50_ms']}/{row['ttft_p99_ms']} ms, TPOT "
        f"p50/p99 {row['tpot_p50_ms']}/{row['tpot_p99_ms']} ms; {steps} decode"
        f" steps + {prefill_positions} prefill positions, {calls} program "
        f"calls, decode_attention launches {launches} "
        f"({launches // positions} per position)")
    say("main path row: " + json.dumps(row, sort_keys=True))
    return engine, {"decode_attention": launches}


# -- 5. the whole path, kernel against the model's plain attention ---------------


def whole_path(dev) -> None:
    cfg = get_config(ARCH).replace(param_dtype="float32",
                                   compute_dtype="float32")
    params = tf.init(cfg, SEED, dev)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, 16)).astype(np.int32)
    gen, max_len = 8, 64
    tokens = {}
    for kernel in (True, False):
        engine = ServeEngine(
            ServeConfig(arch=ARCH, slots=1, max_len=max_len, temperature=0.0,
                        decode_kernel=kernel, device=str(dev)),
            model_cfg=cfg, params=params)
        tokens[kernel] = batch_generate(engine, prompt, gen)[0]
    if not np.array_equal(tokens[True], tokens[False]):
        raise AssertionError(f"greedy tokens differ: kernel {tokens[True]} "
                             f"plain {tokens[False]}")
    # teacher-forced: the prefill's logits, then one decode step per token
    cfgs = {kernel: cfg.replace(use_decode_kernel=kernel)
            for kernel in (True, False)}
    state = {kernel: tf.prefill(c, params, tf.init_cache(c, 1, max_len, dev),
                                torch.from_numpy(prompt).to(dev))
             for kernel, c in cfgs.items()}
    worst = 0.0
    for i in range(gen):
        if i:
            tok = torch.tensor([[tokens[True][i - 1]]], dtype=torch.int32,
                               device=dev)
            pos = torch.tensor([prompt.shape[1] + i - 1], dtype=torch.int32,
                               device=dev)
            state = {kernel: tf.decode_step_positions(c, params,
                                                      state[kernel][1], tok,
                                                      pos)
                     for kernel, c in cfgs.items()}
        a, b = state[True][0], state[False][0]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        worst = max(worst, float((a - b).abs().max()))
    ok = worst <= 1e-3
    say(f"whole path: {ARCH} full width float32, 16-token prompt + {gen} "
        f"greedy tokens: tokens identical, logits max|kernel - plain| "
        f"{worst:.3e} (atol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode kernel and plain attention disagree "
                             "over the whole path")


# -- 6. times -------------------------------------------------------------------


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def device_ms(fn, arg_sets, reps: int) -> float:
    """Median device time of one ``fn(*args)`` in ms, over ``reps`` calls
    that rotate through ``arg_sets`` (enough copies that the L2 cache holds
    none of them, as the decode step finds each layer's cache cold).

    A sleep kernel holds the stream while the host enqueues every call
    between CUDA events, so each event pair brackets device work, not the
    host's Python; the sleep is sized from one call's enqueue time, and the
    script checks that it outlasted the whole enqueue.
    """
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[-1])
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 3 * reps * one_ms + 20
    t_sleep = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    t_sleep[0].record()
    torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
    t_sleep[1].record()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
        ev[i + 1].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    slept_ms = t_sleep[0].elapsed_time(t_sleep[1])
    if enqueue_ms >= slept_ms:
        raise RuntimeError(f"enqueue took {enqueue_ms:.1f} ms, longer than "
                           f"the {slept_ms:.1f} ms sleep: times would include "
                           "host gaps")
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def _library_decode(q, k, v, mask):
    # one PyTorch call for the same function: SDPA with the KV heads shared
    # by their query groups (a yardstick only; the port never calls it)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).transpose(1, 2)


def decode_bound_ms(q, k, index) -> tuple[float, str]:
    """Least time for one call on these inputs: the K and V rows each batch
    row attends to (0 .. index[b]), plus q, the output and the indices,
    over the HBM rate; against 4*H*D operations per attended row over the
    peak for the dtype.  Returns (ms, "bytes" or "operations")."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    rows = int((index.long().cpu().clamp(max=k.shape[1] - 1) + 1).sum())
    es = q.element_size()
    nbytes = 2 * rows * kv * d * es + 2 * q.numel() * es + 4 * b
    ops = 4 * rows * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_decode(shape, dev, smi) -> dict:
    b, l, h, kv, d = (shape[x] for x in ("b", "l", "h", "kv", "d"))
    dtype = torch.bfloat16
    per_copy = 2 * b * l * kv * d * 2
    copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
    rows = [l - 1] * b              # decode at a full cache of L rows
    sets = [_decode_inputs(b, l, h, kv, d, dtype, rows, seed=100 + i, dev=dev)
            for i in range(copies)]
    kj = torch.arange(l, device=dev)
    masks = [(kj[None, :] <= s[3].long()[:, None])[:, None, None, :]
             for s in sets]
    lib_sets = [(q, k, v, m) for (q, k, v, _), m in zip(sets, masks)]
    # the yardstick must compute the same function
    q, k, v, idx = sets[0]
    lib_err = float((_library_decode(q, k, v, masks[0]).float()
                     - decode_attention_plain(q, k, v, idx).float()
                     ).abs().max())
    if not lib_err <= TOL[dtype]:
        raise AssertionError(f"library call disagrees with the plain version "
                             f"by {lib_err:.3e}")
    reps = max(30, 3 * copies)
    kernel_ms = device_ms(decode_ops.decode_attention, sets, reps)
    plain_ms = device_ms(decode_attention_plain, sets, reps)
    library_ms = device_ms(_library_decode, lib_sets, reps)
    bound_ms, bound_by = decode_bound_ms(q, k, idx)
    say(f"times: decode_attention B={b} L={l} H={h} KV={kv} D={d} bfloat16, "
        f"every row at index {l - 1}, {copies} rotating copies, median of "
        f"{reps}, on {smi}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA, enable_gqa) {library_ms:.4f} ms,"
        f" bound {bound_ms:.4f} ms ({bound_by}; "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def time_decode_step(engine, smi, position: int = 64) -> None:
    """One full-width decode step of every slot at ``position``: its time on
    the host clock (call + synchronise), its time on the device (the same
    step captured in a CUDA graph and replayed, so the host's per-op cost
    is out of the way; a capture also fails if the step syncs to the host),
    and the decode kernel's share of the device time."""
    mcfg, dev, slots = engine.model_cfg, engine.device, engine.cfg.slots
    tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    positions = torch.full((slots,), position, dtype=torch.int32, device=dev)
    args = (mcfg, engine.params, engine.cache, tokens, positions)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        tf.decode_step_positions(*args)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tf.decode_step_positions(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tf.decode_step_positions(*args)
    step_ms = device_ms(graph.replay, [()], 20)
    q = torch.randn((slots, 1, mcfg.n_heads, mcfg.head_dim), device=dev
                    ).to(mcfg.cdtype)
    layers = [(q, engine.cache["k"][i], engine.cache["v"][i], positions)
              for i in range(mcfg.n_layers)]     # each layer's cache, cold
    kernel_ms = device_ms(decode_ops.decode_attention, layers, 64)
    say(f"decode step: {ARCH} full width bfloat16, {slots} slots at position"
        f" {position} of {engine.cfg.max_len}, medians, on {smi}: host "
        f"{host_ms:.4f} ms, device {step_ms:.4f} ms (CUDA graph replay), "
        f"device idle {100 * (1 - step_ms / host_ms):.1f}% of the host step;"
        f" decode_attention {kernel_ms:.4f} ms x {mcfg.n_layers} layers = "
        f"{100 * mcfg.n_layers * kernel_ms / step_ms:.1f}% of the device step")


# -- main -----------------------------------------------------------------------


def main() -> int:
    smi = card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build()
    worst = kernel_vs_plain(dev)
    engine, launches = main_path(dev, smi)
    time_decode_step(engine, smi)
    del engine
    whole_path(dev)
    serve_times = time_decode(SERVE_SHAPE, dev, smi)
    time_decode(LONG_SHAPE, dev, smi)
    lines = [{**KERNELS[0], "launches": launches["decode_attention"],
              "max_abs_err": worst, **serve_times}]
    if any(k["launches"] < 1 for k in lines):
        raise AssertionError("a kernel of the serving path never launched")
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s "
        f"on {smi}")
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

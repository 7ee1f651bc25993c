#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports only ``repro_torch`` (from ``src/``), ``torch``, ``numpy`` and the
standard library, and runs these phases in order; any failure raises and the
script exits non-zero, printing no result:

  1. card    — the card's name and power limit from ``nvidia-smi``;
  2. build   — ``nvcc`` builds every kernel of the serving and training
     paths from ``src/repro_torch/csrc`` (one process per source, all at
     once);
  3. kernel vs plain — each kernel against its plain PyTorch version on
     the card, in bfloat16 and float32: ``decode_attention`` at the shapes
     of ``tests/test_kernels.py``, the serving shape and a long cache, with
     per-row indices that include 0 and L-1; ``ghost_norm`` at the shapes
     of ``tests/test_kernels.py`` and at the training shapes (B=16, S=256,
     every dense layer of SmolLM-360M and its head), also with a and g in
     different dtypes (bf16 and float32 either way round), as a round
     meets once the parameters are float32;
  4. serve main path — ``ServeEngine`` serves SmolLM-360M at full width in
     bfloat16 (seeded random weights) over a seeded open-loop trace; every
     request must complete, and the decode kernel's launch count must equal
     n_layers x (decode steps + prefill positions);
  5. serve whole path — at full width in float32, ``decode_kernel=True``
     against ``decode_kernel=False`` (the model's plain attention): the
     same greedy tokens, logits within atol 1e-3;
  6. train main path — ``arms.run("decaph", ...)`` trains SmolLM-360M with
     an untied head (408,944,640 parameters) at full width for 3 rounds on
     4 ``token_silos`` hospitals (64 sequences of 256 tokens each, batch
     16, sigma 1.0) with ghost clipping: 3 rounds complete, the losses are
     finite, ε is the accountant's, one program call per round, and
     ``ghost_norm`` launches 225 times per participant and round;
  7. train whole path — one sigma = 0 round in float32 with the kernel and
     one with the plain ghost norm: the norms agree at rtol 1e-4 and the
     two rounds' updates (trained - initial parameters) within 1e-5 in L2;
  8. times — each kernel, its plain version and one PyTorch library call
     (a yardstick the port never calls) on CUDA events, beside the least
     time the card could take; a training round's wall time, and a
     profiled round's device busy time and ``ghost_norm`` share.

The next-to-last line is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.arms as arms  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import param_count  # noqa: E402
from repro_torch.core import ghost as ghost_lib  # noqa: E402
from repro_torch.core.accountant import RDPAccountant  # noqa: E402
from repro_torch.core.dp import DPConfig  # noqa: E402
from repro_torch.instrument import jit_dispatches, reset_jit_dispatches  # noqa: E402
from repro_torch.kernels import KERNEL_SOURCES, _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: E402
from repro_torch.kernels.ghost_norm import ops as ghost_ops  # noqa: E402
from repro_torch.kernels.ghost_norm.ops import ghost_norm_blocked  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.federation import token_silos, transformer_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
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

# ghost_norm (b, s, d_in, d_out): the shapes of tests/test_kernels.py, then
# the training shapes — B=16 rows of S=256 tokens through SmolLM-360M's dense
# layers (q and o 960->960, k and v 960->320, up and gate 960->2560, down
# 2560->960) and its untied head (960->49152) — with the launches of each per
# participant and round
GHOST_TEST_CASES = [(2, 64, 32, 16), (1, 96, 48, 48), (3, 128, 64, 8),
                    (2, 32, 16, 16)]
GHOST_TRAIN_SHAPES = {(16, 256, 960, 960): 64, (16, 256, 960, 320): 64,
                      (16, 256, 960, 2560): 64, (16, 256, 2560, 960): 32,
                      (16, 256, 960, 49152): 1}
GHOST_ROW_SHAPE = (16, 256, 960, 2560)   # the kernels line's ghost_norm times
GHOST_RTOL = 1e-4   # kernel vs plain: the same float32 sums, other order

# the training run: 4 hospitals x 64 sequences of 256 tokens, batch 16
TRAIN = dict(hospitals=4, n_per=64, seq_len=256, rounds=3, batch_size=16,
             lr=0.05, clip=1.0, sigma=1.0)
TRAIN_PARAMS = 408_944_640   # SmolLM-360M, untied head (param_count: no norms)

# one entry per kernel on the serving and training paths
KERNELS = [{
    "name": "decode_attention",
    "route": "cuda",
    "source": "src/repro_torch/csrc/decode_attention.cu",
    "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
}, {
    "name": "ghost_norm",
    "route": "cuda",
    "source": "src/repro_torch/csrc/ghost_norm.cu",
    "replaces": "src/repro/kernels/ghost_norm/kernel.py:44",
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


def _ghost_inputs(b, s, d_in, d_out, dtype, seed, dev, *, unit=False,
                  g_dtype=None):
    """a and g for one ghost-norm call, a in ``dtype`` and g in ``g_dtype``
    (default: ``dtype``).  ``unit``: activations of unit scale and
    cotangents scaled so each example's norm^2 is about 1, as in training;
    otherwise the scales of tests/test_kernels.py."""
    g_ = torch.Generator(device=dev).manual_seed(seed)
    sa, sg = (1.0, 1.0 / math.sqrt(s * d_in * d_out)) if unit else (0.5, 0.1)
    a = (sa * torch.randn((b, s, d_in), generator=g_, device=dev)).to(dtype)
    g = (sg * torch.randn((b, s, d_out), generator=g_, device=dev)).to(
        g_dtype or dtype)
    return a, g


# (a, g) dtypes: the same in both, and the mixed pairs a training round
# meets once float32 gradients have promoted the parameters (layer 0's q,
# k and v projections take bf16 activations and float32 cotangents)
GHOST_DTYPES = [(torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.float32),
                (torch.bfloat16, torch.float32),
                (torch.float32, torch.bfloat16)]


def ghost_vs_plain(dev) -> float:
    """ghost_norm against its plain version on every case in every (a, g)
    dtype pair (|kernel - plain| <= GHOST_RTOL * |plain| + 1e-6); returns
    the largest |kernel - plain|."""
    worst = 0.0
    cases = [(c, False) for c in GHOST_TEST_CASES] + \
        [(c, True) for c in GHOST_TRAIN_SHAPES]
    for i, ((b, s, d_in, d_out), unit) in enumerate(cases):
        for a_dtype, g_dtype in GHOST_DTYPES:
            a, g = _ghost_inputs(b, s, d_in, d_out, a_dtype, i, dev,
                                 unit=unit, g_dtype=g_dtype)
            out = ghost_ops.ghost_norm(a, g)
            ref = ghost_norm_blocked(a, g)
            torch.cuda.synchronize()
            if out.shape != (b,) or out.dtype != torch.float32:
                raise AssertionError(f"kernel output {tuple(out.shape)} "
                                     f"{out.dtype}, expected ({b},) float32")
            err = (out - ref).abs()
            ok = bool(torch.all(err <= GHOST_RTOL * ref.abs() + 1e-6))
            rel = float((err / ref.abs().clamp(min=1e-30)).max())
            say(f"kernel vs plain: ghost_norm B={b} S={s} d_in={d_in} "
                f"d_out={d_out} a {str(a_dtype)[6:]}, g {str(g_dtype)[6:]}: "
                f"max|err| {float(err.max()):.3e}, max rel {rel:.3e} (rtol "
                f"{GHOST_RTOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("ghost_norm disagrees with its plain "
                                     "version")
            worst = max(worst, float(err.max()))
    return worst


# -- 4. the serve main path -----------------------------------------------------------


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


# -- 5. the serve whole path, kernel against the model's plain attention ---------


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


# -- 6. the training main path ------------------------------------------------


def _train_cfg(rounds: int, sigma: float) -> arms.ArmConfig:
    return arms.ArmConfig(
        rounds=rounds, batch_size=TRAIN["batch_size"], lr=TRAIN["lr"],
        seed=SEED, use_secagg=False,
        dp=DPConfig(clip_norm=TRAIN["clip"], noise_multiplier=sigma))


def _silos(mcfg):
    return token_silos(mcfg, hospitals=TRAIN["hospitals"],
                       n_per=TRAIN["n_per"], seq_len=TRAIN["seq_len"],
                       seed=SEED)


def train_main_path(dev, smi) -> dict:
    """DeCaPH rounds with ghost clipping at full width; returns the
    ghost_norm launches of the run and its round wall times."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False)
    if param_count(mcfg) != TRAIN_PARAMS:
        raise AssertionError(f"{param_count(mcfg)} parameters, expected "
                             f"{TRAIN_PARAMS}")
    model = transformer_model(mcfg, device=str(dev))
    silos = _silos(mcfg)
    cfg = _train_cfg(TRAIN["rounds"], TRAIN["sigma"])
    marks, dtypes = [], []

    def on_round(t, params):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        dtypes.append(sorted({str(p.dtype)[6:] for p in tree_leaves(params)}))

    torch.cuda.reset_peak_memory_stats()
    ghost_ops.reset_launches()
    reset_jit_dispatches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = arms.run("decaph", model, silos, cfg, backend="ideal",
                      on_round=on_round)
    launches = ghost_ops.launches()
    calls = jit_dispatches()

    n_params = sum(p.numel() for p in tree_leaves(report.params))
    norm_scales = (2 * mcfg.n_layers + 1) * mcfg.d_model
    if n_params != TRAIN_PARAMS + norm_scales:
        raise AssertionError(f"trained {n_params} parameters, expected "
                             f"{TRAIN_PARAMS} + {norm_scales} norm scales")
    if report.rounds_completed != TRAIN["rounds"] or len(marks) != \
            TRAIN["rounds"]:
        raise AssertionError(f"{report.rounds_completed} rounds completed, "
                             f"expected {TRAIN['rounds']}")
    losses = [l.loss for l in report.logs]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite round losses {losses}")
    if not all(bool(torch.isfinite(p).all())
               for p in tree_leaves(report.params)):
        raise AssertionError("non-finite trained parameters")
    acct = RDPAccountant(sampling_rate=TRAIN["batch_size"]
                         / (TRAIN["hospitals"] * TRAIN["n_per"]),
                         noise_multiplier=TRAIN["sigma"], delta=cfg.dp.delta)
    acct.step(TRAIN["rounds"])
    if report.epsilon != acct.epsilon():
        raise AssertionError(f"ε {report.epsilon} != the accountant's "
                             f"{acct.epsilon()}")
    if calls != TRAIN["rounds"]:
        raise AssertionError(f"{calls} program calls for "
                             f"{TRAIN['rounds']} fused rounds")
    per_participant = 7 * mcfg.n_layers + 1
    expected = per_participant * TRAIN["hospitals"] * TRAIN["rounds"]
    if launches != expected:
        raise AssertionError(f"ghost_norm launched {launches} times, "
                             f"expected {per_participant} x "
                             f"{TRAIN['hospitals']} participants x "
                             f"{TRAIN['rounds']} rounds = {expected}")
    round_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    say(f"train main path: {ARCH} untied head, {TRAIN_PARAMS:,} parameters "
        f"(+ {norm_scales:,} norm scales), full"
        f" width, {TRAIN['hospitals']} hospitals x {TRAIN['n_per']} x "
        f"{TRAIN['seq_len']} tokens, batch {TRAIN['batch_size']}, sigma "
        f"{TRAIN['sigma']}, ghost clipping, on {smi}: {report.rounds_completed}"
        f" rounds, aggregate batches "
        f"{[l.aggregate_batch for l in report.logs]}, losses "
        f"{[round(x, 4) for x in losses]}, ε {report.epsilon:.6f} (accountant"
        f" {acct.epsilon():.6f}), {calls} program calls, ghost_norm launches "
        f"{launches} ({per_participant} per participant and round), round "
        f"wall s {[round(x, 4) for x in round_s]}, parameter dtypes after "
        f"each round {dtypes}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": launches, "round_s": round_s, "model": model,
            "silos": silos, "params": report.params}


def train_whole_path(dev, silos) -> None:
    """One sigma = 0 round in float32 with the kernel and one with the plain
    ghost norm, from the same parameters.  The norms agree at rtol 1e-4.
    The round's update is lr * (sum of clipped gradients) / batch, and a
    relative norm error e moves each clipped gradient (of L2 norm <= C) by
    at most C * e in L2, so the two updates (trained - initial parameters,
    over the whole tree) differ by at most lr * C * 1e-4 = 5e-6 in L2; the
    limit is twice that, for float32 sums ordered differently.  Updates, not
    parameters: one clipped step spreads at most lr * C over 409M elements,
    below any useful per-element tolerance on the parameters themselves."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    model = transformer_model(mcfg, device=str(dev))
    params = model.init_fn(SEED)
    model = dataclasses.replace(model, init_fn=lambda seed: params)
    x = torch.from_numpy(silos[0].x[:16]).to(dev)
    batch = {"tokens": x.long(),
             "labels": torch.from_numpy(silos[0].y[:16]).to(dev).long()}
    mask = torch.zeros(16, device=dev)
    mask[:4] = 1.0
    norms, trained = {}, {}
    for kernel in (True, False):
        impl = ghost_ops.ghost_norm if kernel else ghost_norm_blocked
        with mock.patch.object(ghost_lib, "ghost_norm", impl):
            before = ghost_ops.launches()
            _, _, norms[kernel] = ghost_lib.ghost_clipped_grad_sum(
                mcfg, params, batch, clip_norm=TRAIN["clip"], mask=mask)
            trained[kernel] = arms.run("decaph", model, silos,
                                       _train_cfg(1, 0.0)).params
            if (ghost_ops.launches() > before) != kernel:
                raise AssertionError("the kernel was launched where it "
                                     "should not be, or not where it should")
    nk, npl = norms[True], norms[False]
    norm_ok = bool(torch.all((nk - npl).abs() <= 1e-4 * npl.abs())) and \
        bool(torch.all(nk[4:] == 0))
    diff_sq = upd_sq = 0.0
    for p0, pk, pp in zip(tree_leaves(params), tree_leaves(trained[True]),
                          tree_leaves(trained[False])):
        uk, up = pk.double() - p0.double(), pp.double() - p0.double()
        diff_sq += float((uk - up).square().sum())
        upd_sq += float(up.square().sum())
    diff, upd = math.sqrt(diff_sq), math.sqrt(upd_sq)
    limit = 2 * TRAIN["lr"] * TRAIN["clip"] * 1e-4
    ok = norm_ok and diff <= limit and upd > 0
    say(f"train whole path: {ARCH} untied head, full width float32, sigma 0, "
        f"kernel vs plain ghost norm: norms {[round(float(v), 6) for v in nk[:4]]}"
        f" vs {[round(float(v), 6) for v in npl[:4]]} (rtol 1e-4, pad rows "
        f"0); one round's update, L2 over the tree: plain {upd:.6e}, "
        f"|kernel - plain| {diff:.3e} (limit {limit:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ghost-norm kernel and the plain ghost norm "
                             "disagree over a training round")


# -- 7. times -------------------------------------------------------------------


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


def _library_ghost(a, g):
    # the per-example-gradient approach: materialise A_b^T G_b with one
    # batched product, then its squared Frobenius norm (a yardstick only;
    # the port never calls it)
    return torch.bmm(a.mT, g).float().square().sum(dim=(1, 2))


def ghost_bound_ms(a, g) -> tuple[float, str]:
    """Least time for one call: a and g read once and [B] float32 written,
    over the HBM rate; against the two Gram products' upper triangles (the
    Grams are symmetric), B*S*(S+1)*(d_in+d_out) operations, over the peak
    for the wider of the two dtypes."""
    b, s, d_in = a.shape
    nbytes = a.numel() * a.element_size() + g.numel() * g.element_size() \
        + 4 * b
    ops = b * s * (s + 1) * (d_in + g.shape[2])
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / min(PEAK_OPS_PER_S[a.dtype], PEAK_OPS_PER_S[g.dtype])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_ghost(dev, smi) -> dict:
    """ghost_norm, its plain version and the library yardstick at every
    training shape in both dtypes; returns the GHOST_ROW_SHAPE bfloat16
    times for the kernels line and prints each participant's sum."""
    rows, per_participant = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for i, (shape, count) in enumerate(GHOST_TRAIN_SHAPES.items()):
            b, s, d_in, d_out = shape
            per_copy = b * s * (d_in + d_out) * (2 if dtype ==
                                                 torch.bfloat16 else 4)
            copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
            sets = [_ghost_inputs(b, s, d_in, d_out, dtype, 200 + 10 * i + c,
                                  dev, unit=True) for c in range(copies)]
            a, g = sets[0]
            lib_err = float(((_library_ghost(a, g) - ghost_norm_blocked(a, g))
                             .abs() / ghost_norm_blocked(a, g).abs()).max())
            if not lib_err <= 3e-2:
                raise AssertionError(f"library call disagrees with the plain "
                                     f"version by {lib_err:.3e} (relative)")
            reps = 20 if d_out > 10_000 else 40
            row = {"ms": device_ms(ghost_ops.ghost_norm, sets, reps),
                   "plain_ms": device_ms(ghost_norm_blocked, sets, reps),
                   "library_ms": device_ms(_library_ghost, sets, reps)}
            row["bound_ms"], row["bound_by"] = ghost_bound_ms(a, g)
            say(f"times: ghost_norm B={b} S={s} d_in={d_in} d_out={d_out} "
                f"{str(dtype)[6:]}, {copies} rotating copies, median of "
                f"{reps}, on {smi}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library (bmm + squared norm) "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; {100 * row['bound_ms'] / row['ms']:.1f}%"
                f" of bound); {count} per participant and round")
            rows[(shape, dtype)] = row
            for k in total:
                total[k] += count * row[k]
            del sets, a, g
        per_participant[dtype] = total
        say(f"times: ghost_norm per participant and round ({sum(GHOST_TRAIN_SHAPES.values())}"
            f" launches) {str(dtype)[6:]}, on {smi}: kernel "
            f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, library "
            f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    return {"row": rows[(GHOST_ROW_SHAPE, torch.bfloat16)],
            "per_participant": per_participant}


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        us = getattr(evt, name, None)
        if us is not None:
            return float(us)
    return 0.0


def profile_round(dev, smi, train, ghost) -> None:
    """One steady-state round: float32 (as rounds 2 and on are), from the
    trained parameters, its arm built beforehand.  After a warm-up round
    (the allocator refills after the times phase), it runs once on the
    host clock and once more under ``torch.profiler``, which gives the
    device's busy time (the sum of every kernel's device time) and
    ghost_norm's share of it; the device idle share is busy time against
    the unprofiled wall time.  Beside it the main-path round times and the
    kernel share that the times phase's medians imply."""
    steady = dataclasses.replace(train["model"],
                                 init_fn=lambda seed: train["params"])
    cfg = _train_cfg(1, TRAIN["sigma"])
    t0 = time.perf_counter()
    arm = arms.get("decaph")(steady, train["silos"], cfg)
    build_s = time.perf_counter() - t0
    warm, arm_again = (arms.get("decaph")(steady, train["silos"], cfg)
                       for _ in range(2))
    arms.LocalRunner().run(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arms.LocalRunner().run(arm)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        arms.LocalRunner().run(arm_again)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_us = ghost_us = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        busy_us += us
        if "ghost_norm" in evt.key:
            ghost_us += us
    round_s = train["round_s"]
    est = {dt: TRAIN["hospitals"] * ghost["per_participant"][dt]["ms"]
           for dt in (torch.bfloat16, torch.float32)}
    say(f"train round: {ARCH} untied head full width, {TRAIN['hospitals']} "
        f"participants, on {smi}: main-path round wall s "
        f"{[round(x, 4) for x in round_s]} (round 1 computes in bfloat16 and "
        f"includes building the model and the arm; stepping float32 "
        f"gradients makes the parameters float32, so rounds 2 and on compute"
        f" in float32); ghost_norm at the times phase's medians: "
        f"{est[torch.bfloat16]:.2f} ms per bfloat16 round, "
        f"{est[torch.float32]:.2f} ms per float32 round = "
        f"{100 * est[torch.float32] / (1e3 * round_s[-1]):.1f}% of round "
        f"{len(round_s)}; building the arm {build_s:.3f} s")
    if busy_us <= 0:
        say(f"train round profile: steady float32 round wall {wall_ms:.1f} "
            f"ms; torch.profiler recorded no device time on this machine, so"
            f" device busy and idle share are not measured")
        return
    say(f"train round profile: steady float32 round, on {smi}: wall "
        f"{wall_ms:.1f} ms ({prof_ms:.1f} ms with the profiler on), device "
        f"busy {busy_us / 1e3:.1f} ms, device idle "
        f"{100 * (1 - busy_us / 1e3 / wall_ms):.1f}% of the round; "
        f"ghost_norm {ghost_us / 1e3:.1f} ms = {100 * ghost_us / busy_us:.1f}%"
        f" of device busy time, {100 * ghost_us / 1e3 / wall_ms:.1f}% of the "
        f"round")


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
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build()
    worst = {"decode_attention": kernel_vs_plain(dev),
             "ghost_norm": ghost_vs_plain(dev)}
    engine, launches = main_path(dev, smi)
    time_decode_step(engine, smi)
    del engine
    whole_path(dev)
    torch.cuda.empty_cache()
    train = train_main_path(dev, smi)
    launches["ghost_norm"] = train["launches"]
    train_whole_path(dev, train["silos"])
    torch.cuda.empty_cache()
    times = {"decode_attention": time_decode(SERVE_SHAPE, dev, smi)}
    time_decode(LONG_SHAPE, dev, smi)
    ghost = time_ghost(dev, smi)
    times["ghost_norm"] = ghost["row"]
    profile_round(dev, smi, train, ghost)
    lines = [{**k, "launches": launches[k["name"]],
              "max_abs_err": worst[k["name"]], **times[k["name"]]}
             for k in KERNELS]
    if any(k["launches"] < 1 for k in lines):
        raise AssertionError("a kernel of the main paths never launched")
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s "
        f"on {smi}")
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

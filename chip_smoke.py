#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports only ``repro_torch`` (from ``src/``), ``torch``, ``numpy`` and the
standard library, and runs these phases in order; any failure raises and the
script exits non-zero, printing no result:

  1. card    — the card's name and power limit from ``nvidia-smi``;
  2. build   — ``nvcc`` builds every kernel of the serving, training and
     evaluation paths from ``src/repro_torch/csrc`` (one process per
     source, all at once) and prints each kernel's registers, static
     shared memory and spills as ``ptxas -v`` reported them, and the HMMA
     (tensor-core) instructions of each flash and ghost-norm kernel where
     ``cuobjdump`` exists (the bf16 flash kernels and every ghost-norm
     instantiation, one per (a, g) dtype pair, must have some);
  3. kernel vs plain — each kernel against its plain PyTorch version on
     the card, in bfloat16 and float32, and against a second launch on the
     same inputs bit for bit: ``decode_attention`` at the shapes of
     ``tests/test_kernels.py``, the serving shape and a long cache, with
     per-row indices that include 0 and L-1, and at the edges of its split
     kernel's chunks (index 0, one below, at and one above a chunk
     boundary, a window across two chunks, L not a multiple of the chunk,
     rows of one batch far apart), at 1e-4 in float32 and atol 1e-3 +
     rtol 1e-2 in bfloat16; ``ghost_norm`` at the shapes of
     ``tests/test_kernels.py``, at the training shapes (B=16, S=256,
     every dense layer of SmolLM-360M and its head) and at its tiles' and
     copies' edges (ragged S, widths of one K-step, rows that are not
     16-byte multiples, base addresses off 16 bytes), in every (a, g)
     dtype pair (bf16 and float32 either way round too, as a round meets
     them once the parameters are float32), at rtol 1e-4, and bit for bit
     on a second launch; ``flash_attention`` at the
     shapes of ``tests/test_kernels.py`` (MQA, a window, non-causal), L != S,
     the evaluation shape (B=8, S=2048, 15 heads on 5) and the edges of its
     tiles (ragged S and L, windows of 1, one key tile and three, groups of
     1, 4 and 5, rows that see no key, D = 32 and 128), at atol = rtol =
     3e-5 in float32 and atol 1e-3 + rtol 1e-2 in bfloat16 (a few output
     ulps), each dtype through its own kernel (tensor cores for bf16);
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
     ``ghost_norm`` launches 225 times per participant and round; every
     round is published by a ``CheckpointPublisher(keep_last=2)`` on
     ``on_round`` (the round wall times exclude it; its time per round and
     the file size are printed);
  7. train whole path — one sigma = 0 round in float32 with the kernel and
     one with the plain ghost norm: the norms agree at rtol 1e-4 and the
     two rounds' updates (trained - initial parameters) within 1e-5 in L2;
  8. eval main path — with ``use_flash``, full-sequence ``forward``,
     ``loss_fn`` and ``predict_fn`` of SmolLM-360M (untied head, full
     width) under ``torch.no_grad()`` score 4 held-out ``token_silos``
     hospitals x 2 sequences of 2048 tokens, once with seeded bf16 weights
     and once with phase 6's trained float32 parameters: finite logits and
     loss, exactly 32 ``flash_attention`` launches per forward, all of the
     dtype's kernel (tensor-core bf16, CUDA-core float32), and
     ``predict_fn`` the forward's argmax at the last position; prints the
     pooled next-token accuracy and the mean cross-entropy;
  9. eval whole path — at full width in float32, the forward with
     ``use_flash`` (the kernel) against the model's plain ``_sdpa``:
     logits within atol 1e-3, the same argmax wherever the top two differ
     by more than 2e-3; then the bf16 forward once, with each of the 32
     layers' kernel output held against ``attention_plain`` on that layer's
     own q, k and v at the bf16 limit of phase 3;
 10. blocked training — one sigma = 0 float32 ghost round at full width and
     4 layers (B=4, S=1024: two KV blocks) with ``use_flash``
     (``_sdpa_blocked``) against one without: updates within 1e-5 in L2,
     and no ``flash_attention`` launch;
 11. times — each kernel, its plain version and one PyTorch library call
     (a yardstick the port never calls) on CUDA events, beside the least
     time the card could take (float32 ghost-norm products at the 3xTF32
     rate, a third of TF32's); a training round's wall time, a profiled
     round's device busy time and ``ghost_norm`` share, the wall time of
     one evaluation forward and the flash kernel's share of it, and a
     profiled evaluation forward's device busy time, idle share and top
     device ops;
 12. hot swap — a float32 ``ServeEngine`` (SmolLM-360M, untied head, full
     width, 8 slots x 512, the decode kernel, greedy) starts from seeded
     weights at round -1, admits 4 requests and steps; ``poll_watcher``
     swaps in the newest round phase 6 published (the last one), without
     reallocating the KV cache, and the swapped parameters must be phase
     6's final ones bit for bit; the in-flight requests finish their full
     budget, and 4 requests admitted after the swap emit the greedy tokens
     of an engine built directly from phase 6's parameters (same slots,
     same steps); then ``run_open_loop`` with the watcher serves a seeded
     trace, every request completes, and every step samples
     ``latest_round`` = ``serving_round`` = the last round; prints the
     load-and-swap time, and the publish and the load in their parts
     (copy to the host, write, read and decode, copy to the card).

The next-to-last line is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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
from repro_torch.configs.base import dense_stack, param_count  # noqa: E402
from repro_torch.core import ghost as ghost_lib  # noqa: E402
from repro_torch.core.accountant import RDPAccountant  # noqa: E402
from repro_torch.core.dp import DPConfig  # noqa: E402
from repro_torch.instrument import jit_dispatches, reset_jit_dispatches  # noqa: E402
from repro_torch.kernels import KERNEL_SOURCES, _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_plain  # noqa: E402
from repro_torch.kernels.ghost_norm import ops as ghost_ops  # noqa: E402
from repro_torch.kernels.ghost_norm.ops import ghost_norm_blocked  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.federation import token_silos, transformer_model  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.convert import params_from_tree, params_to_tree  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine, batch_generate  # noqa: E402
from repro_torch.serve.handoff import (  # noqa: E402
    CheckpointPublisher,
    CheckpointWatcher,
    checkpoint_path,
    list_rounds,
)
from repro_torch.serve.metrics import summarize  # noqa: E402
from repro_torch.serve.traffic import (  # noqa: E402
    Request,
    TrafficConfig,
    generate_requests,
    run_open_loop,
)

ARCH = "smollm-360m"
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the ghost-norm kernel's float32 products are three TF32 products each
# (3xTF32 on the tensor cores), so the least time for its float32 work is
# at a third of the TF32 peak; its bf16 products at the bf16 peak
GHOST_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
L2_BYTES = 50 * 2**20
# a library call against the plain version, before it is timed as a
# yardstick (SDPA may round P to bf16, so bf16 gets test_kernels.py's 3e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# decode kernel against its plain version, |err| <= atol + rtol |plain|.
# bfloat16: both sides accumulate in float32 from the same bf16 inputs and
# differ by the output's rounding (<= 1 ulp, 2^-8 of |plain|), as in
# FLASH_TOL; an absolute 3e-2 is as large as the typical output (~0.03 on
# a long cache) and would pass a wrong tile
DECODE_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 1e-2)}

# the serving shape: 8 slots of SmolLM-360M (15 query heads on 5 KV heads of
# 64) with 512 cache rows each, and the same at a long cache
SERVE_SHAPE = dict(b=8, l=512, h=15, kv=5, d=64)
# where the serve main path's positions are (prompts and outputs of a few
# dozen tokens); the decode step is timed there too
SERVE_POSITION = 64
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
# the edges of the kernel's tiles (64 rows) and copies (16 bytes): ragged S;
# widths of one 32-byte K-step (8 float32, 16 bf16 columns); rows that are
# not 16-byte multiples (100, 70 and 33 columns: 200, 140, 66 bytes in
# bf16, 400, 280, 132 in float32), which take 8-, 4- and 2-byte copies;
# one tile pair over wide rows, which split_plan shares among 8 blocks
GHOST_EDGE_CASES = [(4, 300, 100, 70), (2, 100, 33, 37), (2, 64, 8, 16),
                    (1, 65, 16, 8), (3, 200, 960, 320), (1, 64, 4096, 4096)]
# (shape, storage offset in elements): a and g views that start 1, 2 or 3
# elements into their buffers, off a 16-byte address, so the kernel takes
# its narrower copies at widths whose rows are 16-byte multiples
GHOST_OFFSET_CASES = [((2, 128, 64, 48), 1), ((2, 256, 960, 2560), 2),
                      ((3, 100, 40, 24), 3)]
GHOST_TRAIN_SHAPES = {(16, 256, 960, 960): 64, (16, 256, 960, 320): 64,
                      (16, 256, 960, 2560): 64, (16, 256, 2560, 960): 32,
                      (16, 256, 960, 49152): 1}
GHOST_ROW_SHAPE = (16, 256, 960, 2560)   # the kernels line's ghost_norm times
GHOST_RTOL = 1e-4   # kernel vs plain: the same float32 sums, other order

# the training run: 4 hospitals x 64 sequences of 256 tokens, batch 16
TRAIN = dict(hospitals=4, n_per=64, seq_len=256, rounds=3, batch_size=16,
             lr=0.05, clip=1.0, sigma=1.0)
TRAIN_PARAMS = 408_944_640   # SmolLM-360M, untied head (param_count: no norms)

# flash_attention (b, s, l, h, kv, d, causal, window): the shapes of
# tests/test_kernels.py, keys longer than the queries, the evaluation shape
# (8 sequences of 2048 tokens through SmolLM-360M's 15 heads on 5), then the
# edges of the kernels' tiles (64 query rows; 64 keys in bf16, 32 in
# float32): ragged S and L, windows of 1, of one key tile and across three,
# groups of 1, 4 and 5, and L < S with a window, where late rows see no key
# and come out 0 (with L > S every row i sees key i)
FLASH_CASES = [
    (1, 128, 128, 4, 2, 32, True, None),
    (2, 128, 128, 4, 4, 64, True, 32),
    (1, 256, 256, 8, 2, 32, False, None),
    (1, 128, 128, 2, 1, 128, True, None),
    (2, 64, 192, 6, 2, 64, True, 48),
    (8, 2048, 2048, 15, 5, 64, True, None),
    (2, 96, 96, 15, 5, 64, True, None),
    (1, 200, 200, 15, 5, 64, True, None),
    (1, 200, 200, 15, 5, 64, True, 1),
    (2, 256, 256, 4, 4, 64, True, 64),
    (1, 320, 320, 8, 2, 64, True, 150),
    (1, 128, 128, 5, 1, 32, True, None),
    (1, 128, 320, 8, 2, 64, True, 100),
    (1, 200, 72, 15, 5, 64, True, 40),
    (1, 96, 160, 4, 1, 64, False, 50),
    (1, 200, 200, 4, 2, 32, True, 70),
    (2, 200, 200, 8, 2, 128, True, None),
]
# |kernel - plain| <= atol + rtol * |plain|, as (atol, rtol).  float32:
# test_kernels.py's 3e-5.  bfloat16: both sides accumulate in float32 from
# the same bf16 inputs (the kernel on tensor cores, with P in two bf16 terms,
# about 2^-17 of each probability) and differ by the output's rounding
# (<= 1 ulp, 2^-8 of |plain|), so rtol 1e-2 (2.5 ulps) and atol 1e-3, under
# the typical output of ~0.03 on a long row; test_kernels.py's 3e-2 would
# pass a wrong tile.
FLASH_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (1e-3, 1e-2)}
EVAL_SHAPE = dict(b=8, s=2048, h=15, kv=5, d=64)

# the evaluation: 4 held-out hospitals x 2 sequences of 2048 tokens (B=8),
# scored with use_flash at full width
EVAL = dict(hospitals=4, n_per=2, seq_len=2048, seed=1)
# the blocked training round: full width, 4 layers, B=4 rows of S=1024
# tokens, so _sdpa_blocked's 512-key blocks really are two
BLOCKED = dict(n_layers=4, hospitals=2, n_per=8, seq_len=1024, batch_size=4)

# one entry per kernel on the serving, training and evaluation paths
KERNELS = [{
    "name": "decode_attention",
    "route": "cuda",
    "source": "src/repro_torch/csrc/decode_attention.cu",
    "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
}, {
    "name": "flash_attention",
    "route": "cuda",
    "source": "src/repro_torch/csrc/flash_attention.cu",
    "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
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


def _short(kernel: str) -> str:
    """A demangled kernel name without its anonymous namespace, the casts
    of its template arguments, its return type and its parameters."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:unsigned )?int\)",
                  "", kernel)
    return name.split("(", 1)[0].removeprefix("void ")


def build() -> None:
    """Build every source; print each kernel's registers, static shared
    memory and spills as ptxas reported them, the ghost-norm kernel's
    dynamic shared memory and resident blocks per SM, and the tensor-core
    (HMMA) instructions per flash and ghost-norm kernel."""
    spent = _build.build(KERNEL_SOURCES)
    say(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} -> "
        f"{', '.join(_build.library_path(n).name for n in KERNEL_SOURCES)} "
        f"in {spent:.2f} s")
    for name in KERNEL_SOURCES:
        for r in _build.resources(name):
            say(f"resources: {name}.cu {_short(r['kernel'])}: "
                f"{r['registers']} registers, {r['smem']} B static shared "
                f"memory, {r['stack']} B stack, spills {r['spill_stores']} B "
                f"stored / {r['spill_loads']} B loaded")
    for ta, tg in GHOST_DTYPES:
        blocks = ghost_ops.blocks_per_sm(ta, tg)
        say(f"resources: ghost_norm.cu ghost_norm_tiles a {str(ta)[6:]}, g "
            f"{str(tg)[6:]}: {ghost_ops.smem_bytes(ta, tg)} B dynamic shared"
            f" memory, {blocks} blocks resident per SM")
        if blocks < 2:
            raise AssertionError("fewer than 2 ghost-norm blocks fit on an SM")
    for name, tensor_core in (("flash_attention", "mma_kernel"),
                              ("ghost_norm", "ghost_norm_tiles")):
        hmma = _build.sass_counts(name, "HMMA")
        if hmma is None:
            say("sass: no cuobjdump on this machine; HMMA not counted")
            return
        say(f"sass: HMMA instructions in {name}.cu: " +
            ", ".join(f"{_short(k)} {n}" for k, n in hmma.items()))
        mma = [n for k, n in hmma.items() if tensor_core in k]
        want = len(flash_ops.HEAD_DIMS) if name == "flash_attention" else \
            len(GHOST_DTYPES)
        if len(mma) != want or min(mma) < 1:
            raise AssertionError(f"a tensor-core kernel of {name}.cu has no "
                                 f"tensor-core instructions")


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
            worst = max(worst, _decode_check(q, k, v, idx, window, ""))
    for i, (rows, l, h, kv, d, window, what) in enumerate(
            _decode_split_cases(dev)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, idx = _decode_inputs(len(rows), l, h, kv, d, dtype, rows,
                                          seed=50 + i, dev=dev)
            worst = max(worst, _decode_check(q, k, v, idx, window, what))
    return worst


def _decode_split_cases(dev) -> list:
    """(rows, l, h, kv, d, window, what): the split kernel's edges, with c
    the chunk ``split_plan`` gives the case's shapes."""
    cases = []
    for l, h, kv, d in [(512, 15, 5, 64), (1000, 15, 5, 64),
                        (1000, 8, 1, 128), (300, 4, 2, 32)]:
        n, c = decode_ops.split_plan(8, l, kv, decode_ops.sm_count(dev))
        cases += [
            ([0] * 8, l, h, kv, d, None, "index 0"),
            ([c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1, l - 2, l - 1], l,
             h, kv, d, None, f"around the split boundaries (chunk {c})"),
            ([c + c // 2] * 4 + [c + 1] * 4, l, h, kv, d, c,
             f"a window of {c} across two splits"),
            ([0, 1, c, l // 2, l - c - 1, l - 3, l - 2, l - 1], l, h, kv, d,
             None, f"rows far apart, {n} splits of {c} over L={l}"),
        ]
    return cases


def _decode_check(q, k, v, idx, window, what) -> float:
    """The kernel against the plain version at DECODE_TOL, and against a
    second launch bit for bit; returns the largest |kernel - plain|."""
    out = decode_ops.decode_attention(q, k, v, idx, window=window)
    again = decode_ops.decode_attention(q, k, v, idx, window=window)
    ref = decode_attention_plain(q, k, v, idx, window=window)
    torch.cuda.synchronize()
    b, l, kv, d = k.shape
    dtype = q.dtype
    if out.shape != ref.shape or out.dtype != dtype:
        raise AssertionError(f"kernel output {tuple(out.shape)} "
                             f"{out.dtype}, expected {tuple(ref.shape)}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    same = torch.equal(out, again)
    atol, rtol = DECODE_TOL[dtype]
    ok = (math.isfinite(err) and same
          and bool(torch.all(diff <= atol + rtol * ref.float().abs())))
    say(f"kernel vs plain: B={b} L={l} H={q.shape[2]} KV={kv} D={d} "
        f"window={window} {str(dtype)[6:]}{', ' + what if what else ''}: "
        f"max|err| {err:.3e} (atol {atol:g}, rtol {rtol:g}; mean|plain| "
        f"{float(ref.float().abs().mean()):.3e}); repeat "
        f"{'bit-identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode_attention disagrees with its plain "
                             "version, or with itself")
    return err


def _offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of x that starts ``offset`` elements into its
    buffer."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def _ghost_inputs(b, s, d_in, d_out, dtype, seed, dev, *, unit=False,
                  g_dtype=None, offset=0):
    """a and g for one ghost-norm call, a in ``dtype`` and g in ``g_dtype``
    (default: ``dtype``).  ``unit``: activations of unit scale and
    cotangents scaled so each example's norm^2 is about 1, as in training;
    otherwise the scales of tests/test_kernels.py.  ``offset``: both start
    that many elements into their buffers."""
    g_ = torch.Generator(device=dev).manual_seed(seed)
    sa, sg = (1.0, 1.0 / math.sqrt(s * d_in * d_out)) if unit else (0.5, 0.1)
    a = (sa * torch.randn((b, s, d_in), generator=g_, device=dev)).to(dtype)
    g = (sg * torch.randn((b, s, d_out), generator=g_, device=dev)).to(
        g_dtype or dtype)
    if offset:
        a, g = _offset(a, offset), _offset(g, offset)
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
    dtype pair (|kernel - plain| <= GHOST_RTOL * |plain| + 1e-6), and
    against a second launch bit for bit; returns the largest
    |kernel - plain|."""
    worst = 0.0
    cases = [(c, False, 0) for c in GHOST_TEST_CASES + GHOST_EDGE_CASES] + \
        [(c, False, off) for c, off in GHOST_OFFSET_CASES] + \
        [(c, True, 0) for c in GHOST_TRAIN_SHAPES]
    for i, ((b, s, d_in, d_out), unit, offset) in enumerate(cases):
        for a_dtype, g_dtype in GHOST_DTYPES:
            a, g = _ghost_inputs(b, s, d_in, d_out, a_dtype, i, dev,
                                 unit=unit, g_dtype=g_dtype, offset=offset)
            out = ghost_ops.ghost_norm(a, g)
            again = ghost_ops.ghost_norm(a, g)
            ref = ghost_norm_blocked(a, g)
            torch.cuda.synchronize()
            if out.shape != (b,) or out.dtype != torch.float32:
                raise AssertionError(f"kernel output {tuple(out.shape)} "
                                     f"{out.dtype}, expected ({b},) float32")
            err = (out - ref).abs()
            same = torch.equal(out, again)
            ok = bool(torch.all(err <= GHOST_RTOL * ref.abs() + 1e-6)) and \
                same
            rel = float((err / ref.abs().clamp(min=1e-30)).max())
            say(f"kernel vs plain: ghost_norm B={b} S={s} d_in={d_in} "
                f"d_out={d_out} a {str(a_dtype)[6:]}, g {str(g_dtype)[6:]}"
                f"{f', offset {offset}' if offset else ''}: max|err| "
                f"{float(err.max()):.3e}, max rel {rel:.3e} (rtol "
                f"{GHOST_RTOL:g}), second launch "
                f"{'identical' if same else 'DIFFERS'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("ghost_norm disagrees with its plain "
                                     "version, or with itself")
            worst = max(worst, float(err.max()))
    return worst


def _flash_inputs(b, s, l, h, kv, d, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (0.5 * torch.randn((b, s, h, d), generator=g, device=dev)).to(dtype)
    k = (0.5 * torch.randn((b, l, kv, d), generator=g, device=dev)).to(dtype)
    v = torch.randn((b, l, kv, d), generator=g, device=dev).to(dtype)
    return q, k, v


def flash_vs_plain(dev) -> float:
    """flash_attention against attention_plain on every case in both
    dtypes; returns the largest |kernel - plain|."""
    worst = 0.0
    for i, (b, s, l, h, kv, d, causal, window) in enumerate(FLASH_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(b, s, l, h, kv, d, dtype, 300 + i, dev)
            variant = flash_ops.VARIANTS[dtype]
            before = flash_ops.launches(variant)
            # blocks of the whole sequence: the reference's contract takes
            # any S and L that way
            out = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window, block_q=s,
                                            block_k=l)
            again = flash_ops.flash_attention(q, k, v, causal=causal,
                                              window=window, block_q=s,
                                              block_k=l)
            ref = attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"kernel output {tuple(out.shape)} "
                                     f"{out.dtype}, expected {tuple(ref.shape)}")
            err = (out.float() - ref.float()).abs()
            atol, rtol = FLASH_TOL[dtype]
            ok = bool(torch.all(err <= atol + rtol * ref.float().abs()))
            same = torch.equal(out, again)
            ran = flash_ops.launches(variant) - before == 2
            say(f"kernel vs plain: flash_attention B={b} S={s} L={l} H={h} "
                f"KV={kv} D={d} causal={causal} window={window} "
                f"{str(dtype)[6:]} ({variant}): max|err| "
                f"{float(err.max()):.3e} (atol {atol:g}, rtol {rtol:g}; "
                f"mean|plain| {float(ref.float().abs().mean()):.3e}); "
                f"repeat {'bit-identical' if same else 'DIFFERS'} "
                f"{'ok' if ok and same and ran else 'FAIL'}")
            if not (ok and same and ran):
                raise AssertionError("flash_attention disagrees with its "
                                     "plain version, or with itself, or "
                                     "did not run its dtype's kernel")
            worst = max(worst, float(err.max()))
            del q, k, v, out, again, ref, err
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


def train_main_path(dev, smi, ckpt_dir: str) -> dict:
    """DeCaPH rounds with ghost clipping at full width, each round published
    into ``ckpt_dir``; returns the ghost_norm launches of the run and its
    round wall times (without the publishing)."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False)
    if param_count(mcfg) != TRAIN_PARAMS:
        raise AssertionError(f"{param_count(mcfg)} parameters, expected "
                             f"{TRAIN_PARAMS}")
    model = transformer_model(mcfg, device=str(dev))
    silos = _silos(mcfg)
    cfg = _train_cfg(TRAIN["rounds"], TRAIN["sigma"])
    publisher = CheckpointPublisher(
        ckpt_dir, keep_last=2, metadata={"arm": "decaph", "arch": mcfg.name})
    marks, resumes, publish_ms, dtypes = [], [], [], []

    def on_round(t, params):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        dtypes.append(sorted({str(p.dtype)[6:] for p in tree_leaves(params)}))
        publisher.publish(t, params)       # D2H copy + write + rename
        resumes.append(time.perf_counter())
        publish_ms.append((resumes[-1] - marks[-1]) * 1e3)

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
    round_s = [b - a for a, b in zip([t0] + resumes[:-1], marks)]
    if publisher.published != list(range(TRAIN["rounds"])):
        raise AssertionError(f"published rounds {publisher.published}")
    last = TRAIN["rounds"] - 1
    if list_rounds(ckpt_dir) != [last - 1, last]:
        raise AssertionError(f"rounds on disk {list_rounds(ckpt_dir)}, "
                             f"expected the last two (keep_last=2)")
    size = Path(checkpoint_path(ckpt_dir, last)).stat().st_size
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
    say(f"train publish: CheckpointPublisher.publish per round (D2H copy + "
        f"write + rename), ms {[round(x, 2) for x in publish_ms]} on {smi}")
    say(f"train publish: checkpoint file {size:,} bytes "
        f"({size / 2**30:.3f} GiB) per round")
    return {"launches": launches, "round_s": round_s, "model": model,
            "silos": silos, "params": report.params,
            "publish_ms": publish_ms, "ckpt_bytes": size}


def _update_l2(initial, a, b) -> tuple[float, float]:
    """Two rounds' updates (trained - initial, over the whole tree) in
    float64: L2 of their difference, and L2 of b's update."""
    diff_sq = upd_sq = 0.0
    for p0, pa, pb in zip(tree_leaves(initial), tree_leaves(a),
                          tree_leaves(b)):
        ua, ub = pa.double() - p0.double(), pb.double() - p0.double()
        diff_sq += float((ua - ub).square().sum())
        upd_sq += float(ub.square().sum())
    return math.sqrt(diff_sq), math.sqrt(upd_sq)


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
    diff, upd = _update_l2(params, trained[True], trained[False])
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


# -- 8. the evaluation main path ------------------------------------------------


def _eval_batch(mcfg, dev) -> dict:
    """The held-out silos as one batch: tokens [8, 2048] and labels."""
    silos = token_silos(mcfg, **EVAL)
    x = np.concatenate([p.x for p in silos])
    y = np.concatenate([p.y for p in silos])
    return {"tokens": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(y).to(dev)}


def eval_main_path(dev, smi, trained) -> int:
    """Score the held-out silos with use_flash at full width, under
    ``torch.no_grad()``: seeded bf16 weights, then the trained float32
    parameters (whose products promote q, k and v to float32).  Returns
    the flash_attention launches of the run."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False, use_flash=True)
    batch = _eval_batch(mcfg, dev)
    model = transformer_model(mcfg, device=str(dev))
    if trained["layers"]["wq"].dtype != torch.float32:
        raise AssertionError("the trained parameters are not float32")
    # each run's q, k and v are in its weights' dtype, so it must go
    # through that dtype's kernel only
    runs = {"seeded bfloat16": (tf.init(mcfg, SEED, dev), "mma_bf16"),
            "trained float32": (trained, "simt_fp32")}
    n = mcfg.n_layers
    total = 0
    for name, (params, variant) in runs.items():
        flash_ops.reset_launches()
        with torch.no_grad():
            logits, _ = tf.forward(mcfg, params, batch)
            after_forward = flash_ops.launches()
            loss = float(tf.loss_fn(mcfg, params, batch))
            after_loss = flash_ops.launches()
            pred = model.predict_fn(params, batch["tokens"])
            launches = flash_ops.launches()
        b, s = batch["tokens"].shape
        if logits.shape != (b, s, mcfg.vocab_size):
            raise AssertionError(f"logits {tuple(logits.shape)}")
        if not (bool(torch.isfinite(logits).all()) and math.isfinite(loss)):
            raise AssertionError(f"{name}: non-finite logits or loss")
        if (after_forward, after_loss, launches) != (n, 2 * n, 3 * n) or \
                flash_ops.launches(variant) != launches:
            raise AssertionError(
                f"{name}: flash_attention launched {after_forward}, "
                f"{after_loss}, {launches} times after forward, loss_fn and "
                f"predict_fn ({flash_ops.launches(variant)} of them "
                f"{variant}); expected {n} per forward, all {variant}")
        last = torch.argmax(logits[:, -1], dim=-1)
        if not torch.equal(pred, last):
            raise AssertionError(f"{name}: predict_fn {pred.tolist()} is not "
                                 f"the forward's last argmax {last.tolist()}")
        real = batch["labels"] >= 0      # as the "lm" scenarios' pooled_metric
        acc = float((torch.argmax(logits, dim=-1)[real]
                     == batch["labels"][real]).float().mean())
        say(f"eval main path: {ARCH} untied head, full width, {name} "
            f"weights, use_flash, {EVAL['hospitals']} held-out hospitals x "
            f"{EVAL['n_per']} x {EVAL['seq_len']} tokens, on {smi}: "
            f"logits {str(logits.dtype)[6:]} finite, mean cross-entropy "
            f"{loss:.6f}, pooled next-token accuracy {acc:.6f}, predict_fn = "
            f"last-position argmax, flash_attention launches {launches} "
            f"({n} per forward: forward, loss_fn, predict_fn), all of the "
            f"{variant} kernel")
        total += launches
        del logits, pred
    return total


# -- 9. the evaluation whole path, kernel against the model's plain attention ----


def eval_whole_path(dev) -> None:
    mcfg = get_config(ARCH).replace(tie_embeddings=False,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    params = tf.init(mcfg, SEED, dev)
    batch = _eval_batch(mcfg, dev)
    before = flash_ops.launches()
    with torch.no_grad():
        kernel, _ = tf.forward(mcfg.replace(use_flash=True), params, batch)
        if flash_ops.launches() != before + mcfg.n_layers:
            raise AssertionError("the use_flash forward did not launch the "
                                 "kernel once per layer")
        plain, _ = tf.forward(mcfg, params, batch)
    err = float((kernel - plain).abs().max())
    top2 = torch.topk(plain, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2e-3
    same = torch.argmax(kernel, dim=-1) == torch.argmax(plain, dim=-1)
    ok = err <= 1e-3 and bool(same[sure].all()) and math.isfinite(err)
    say(f"eval whole path: {ARCH} untied head, full width float32, B=8 S=2048,"
        f" use_flash (kernel) vs plain _sdpa: logits max|kernel - plain| "
        f"{err:.3e} (atol 1e-3); argmax identical at {int(same[sure].sum())} "
        f"of {int(sure.sum())} positions whose top two differ by > 2e-3 "
        f"({int(same.sum())} of {same.numel()} overall) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the flash kernel and the plain attention "
                             "disagree over the evaluation forward")


def eval_layers_bf16(dev) -> float:
    """The bf16 evaluation forward with the kernel once, every layer's q, k,
    v and attention output captured where ``gqa_apply`` calls the kernel,
    and each layer's output held against ``attention_plain`` on that
    layer's own inputs at FLASH_TOL[bf16]: the kernel on real activations,
    not only on random normals.  Returns the largest |kernel - plain|."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False, use_flash=True)
    params = tf.init(mcfg, SEED, dev)
    batch = _eval_batch(mcfg, dev)
    kernel = attn_lib.flash_attention
    seen = []

    def capture(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q, k, v, kw, out))
        return out

    before = flash_ops.launches("mma_bf16")
    with mock.patch.object(attn_lib, "flash_attention", capture), \
            torch.no_grad():
        logits, _ = tf.forward(mcfg, params, batch)
    if len(seen) != mcfg.n_layers or \
            flash_ops.launches("mma_bf16") != before + mcfg.n_layers:
        raise AssertionError(f"{len(seen)} attention calls, expected "
                             f"{mcfg.n_layers} through the bf16 kernel")
    atol, rtol = FLASH_TOL[torch.bfloat16]
    errs, worst_rel, bad = [], 0.0, []
    for i, (q, k, v, kw, out) in enumerate(seen):
        ref = attention_plain(q, k, v, **kw).float()
        err = (out.float() - ref).abs()
        errs.append(float(err.max()))
        worst_rel = max(worst_rel,
                        float((err / (atol + rtol * ref.abs())).max()))
        if not bool(torch.all(err <= atol + rtol * ref.abs())):
            bad.append(i)
        del ref, err
    seen.clear()
    ok = not bad and bool(torch.isfinite(logits).all())
    say(f"eval whole path: {ARCH} untied head, full width bfloat16, B=8 "
        f"S=2048, use_flash, each layer's kernel output vs attention_plain "
        f"on its own q, k, v: max|err| per layer "
        f"{[float(f'{e:.3e}') for e in errs]} (atol {atol:g}, rtol {rtol:g};"
        f" worst err / limit {worst_rel:.3f}) at {mcfg.n_layers - len(bad)} "
        f"of {mcfg.n_layers} layers {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the bf16 flash kernel disagrees with its plain "
                             f"version on real activations at layers {bad}")
    return max(errs)


# -- 10. blocked training: _sdpa_blocked inside a ghost round ----------------------


def blocked_train_path(dev) -> None:
    """One sigma = 0 float32 ghost round with use_flash (the ghost forward's
    attention is then _sdpa_blocked, two 512-key blocks at S = 1024) and
    one without, from the same parameters: the updates agree within 1e-5
    in L2 and the flash kernel never launches."""
    base = get_config(ARCH).replace(
        tie_embeddings=False, param_dtype="float32", compute_dtype="float32",
        n_layers=BLOCKED["n_layers"], stack=dense_stack(BLOCKED["n_layers"]))
    silos = token_silos(base, hospitals=BLOCKED["hospitals"],
                        n_per=BLOCKED["n_per"], seq_len=BLOCKED["seq_len"],
                        seed=SEED)
    params = tf.init(base, SEED, dev)
    cfg = arms.ArmConfig(rounds=1, batch_size=BLOCKED["batch_size"],
                         lr=TRAIN["lr"], seed=SEED, use_secagg=False,
                         dp=DPConfig(clip_norm=TRAIN["clip"],
                                     noise_multiplier=0.0))
    trained, launches = {}, {}
    for flash in (True, False):
        model = dataclasses.replace(
            transformer_model(base.replace(use_flash=flash), device=str(dev)),
            init_fn=lambda seed: params)
        flash_ops.reset_launches()
        report = arms.run("decaph", model, silos, cfg)
        launches[flash] = flash_ops.launches()
        if report.rounds_completed != 1 or not math.isfinite(
                report.logs[0].loss):
            raise AssertionError("the blocked ghost round did not complete")
        trained[flash] = report.params
    diff, upd = _update_l2(params, trained[True], trained[False])
    ok = diff <= 1e-5 and upd > 0 and launches[True] == launches[False] == 0
    say(f"blocked training: {ARCH} untied head, full width float32, "
        f"{BLOCKED['n_layers']} layers, B={BLOCKED['batch_size']} S="
        f"{BLOCKED['seq_len']}, sigma 0, one ghost round with use_flash "
        f"(_sdpa_blocked, two 512-key blocks) vs plain _sdpa: update L2 "
        f"{upd:.6e}, |blocked - plain| {diff:.3e} (limit 1e-5); "
        f"flash_attention launches {launches[True]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the blocked ghost round disagrees with the "
                             "plain one, or launched the flash kernel")


# -- 11. times -------------------------------------------------------------------


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


def time_decode(shape, dev, smi, position: int | None = None) -> dict:
    """Times at every row's index ``position`` (default L-1, a full cache
    of L rows)."""
    b, l, h, kv, d = (shape[x] for x in ("b", "l", "h", "kv", "d"))
    dtype = torch.bfloat16
    per_copy = 2 * b * l * kv * d * 2
    copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
    position = l - 1 if position is None else position
    rows = [position] * b
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
        f"every row at index {position}, {copies} rotating copies, median of "
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
    Grams are symmetric), B*S*(S+1)*d operations for each, over the peak
    for its operand's dtype (GHOST_OPS_PER_S: float32 at the 3xTF32
    rate)."""
    b, s, d_in = a.shape
    nbytes = a.numel() * a.element_size() + g.numel() * g.element_size() \
        + 4 * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = b * s * (s + 1) * (d_in / GHOST_OPS_PER_S[a.dtype]
                               + g.shape[2] / GHOST_OPS_PER_S[g.dtype])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_ghost(dev, smi) -> dict:
    """ghost_norm, its plain version and the library yardstick at every
    training shape in both dtypes; returns the GHOST_ROW_SHAPE bfloat16
    times for the kernels line (its float32 times are printed beside them)
    and each participant's sums."""
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
    bf, fp = (rows[(GHOST_ROW_SHAPE, dt)]
              for dt in (torch.bfloat16, torch.float32))
    say(f"times: ghost_norm at the kernels line's shape "
        f"{GHOST_ROW_SHAPE}, on {smi}: kernel / plain / library / bound ms "
        f"bfloat16 {bf['ms']:.4f} / {bf['plain_ms']:.4f} / "
        f"{bf['library_ms']:.4f} / {bf['bound_ms']:.4f}, float32 "
        f"{fp['ms']:.4f} / {fp['plain_ms']:.4f} / {fp['library_ms']:.4f} / "
        f"{fp['bound_ms']:.4f}")
    return {"row": bf, "per_participant": per_participant}


def _library_flash(q, k, v):
    # one PyTorch call for the same function: causal SDPA with the KV heads
    # shared by their query groups (a yardstick only; the port never calls
    # it)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def flash_bound_ms(q, k) -> tuple[float, str]:
    """Least time for one causal call on these inputs: q, k, v and the
    output each read or written once, over the HBM rate; against 4*D
    operations per attended (query, key) pair — row i attends min(i+1, L)
    keys, B*H*S*(S+1)/2 pairs at L = S — over the peak for the dtype."""
    b, s, h, d = q.shape
    l = k.shape[1]
    pairs = b * h * int(torch.clamp(torch.arange(1, s + 1), max=l).sum())
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * k.numel() * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * d * pairs / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_flash(dev, smi) -> dict:
    """flash_attention, attention_plain and causal SDPA at the evaluation
    shape in both dtypes; returns the bfloat16 times for the kernels line."""
    b, s, h, kv, d = (EVAL_SHAPE[x] for x in ("b", "s", "h", "kv", "d"))
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_copy = (2 * b * s * h * d + 2 * b * s * kv * d) * (
            2 if dtype == torch.bfloat16 else 4)
        copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
        sets = [_flash_inputs(b, s, s, h, kv, d, dtype, 400 + c, dev)
                for c in range(copies)]
        q, k, v = sets[0]
        lib_err = float((_library_flash(q, k, v).float()
                         - attention_plain(q, k, v).float()).abs().max())
        if not lib_err <= TOL[dtype]:
            raise AssertionError(f"library call disagrees with the plain "
                                 f"version by {lib_err:.3e}")
        row = {"ms": device_ms(flash_ops.flash_attention, sets, 20),
               "plain_ms": device_ms(attention_plain, sets, 6),
               "library_ms": device_ms(_library_flash, sets, 20)}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(q, k)
        say(f"times: flash_attention B={b} S=L={s} H={h} KV={kv} D={d} "
            f"causal {str(dtype)[6:]}, {copies} rotating copies, on {smi}: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library (SDPA, is_causal, enable_gqa) {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound); "
            f"{4 * d * b * h * s * (s + 1) // 2 / 1e9:.1f} GFLOP per call; "
            f"32 per evaluation forward")
        rows[dtype] = row
        del sets, q, k, v
    return rows[torch.bfloat16]


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        us = getattr(evt, name, None)
        if us is not None:
            return float(us)
    return 0.0


def _union_us(spans) -> float:
    """The time covered by (start, end) intervals, each counted once."""
    total, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _device_profile(fn) -> tuple[float, dict, float, list]:
    """``fn()`` once under ``torch.profiler``: the device's busy time in us
    (the union of its kernels' intervals, so that a kernel launched
    programmatically dependent, which waits on the device for the one
    before, counts once; the sum of self times where the trace has no
    intervals), the self device time by kernel name, the host wall time of
    the profiled call in ms, and the (name, start, end) of every device
    event."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + _self_device_us(evt)
    spans = [(evt.name, evt.time_range.start, evt.time_range.end)
             for evt in prof.events()
             if getattr(evt, "device_type", None) ==
             torch.autograd.DeviceType.CUDA]
    busy = _union_us((a, b) for _, a, b in spans) if spans else \
        sum(by_kernel.values())
    return busy, by_kernel, prof_ms, spans


def time_eval_forward(dev, smi, flash_ms: float) -> float:
    """Host wall time of one full-width bf16 evaluation forward (B=8,
    S=2048, use_flash, synchronised), median of 5 after a warm-up; the
    flash kernel's share of it at the times phase's median; then one more
    forward under ``torch.profiler``: the device's busy time, its idle
    share of the unprofiled wall time, and the device ops that take the
    most self time, with their shares of busy time."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False, use_flash=True)
    params = tf.init(mcfg, SEED, dev)
    batch = _eval_batch(mcfg, dev)
    walls = []
    with torch.no_grad():
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tf.forward(mcfg, params, batch)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls)
        share = mcfg.n_layers * flash_ms / wall_ms
        say(f"eval forward: {ARCH} untied head full width bfloat16, use_flash,"
            f" B=8 S=2048, on {smi}: wall {wall_ms:.2f} ms (median of 5); "
            f"flash_attention at the times phase's median: {mcfg.n_layers} x "
            f"{flash_ms:.4f} ms = {100 * share:.1f}% of it")
        busy_us, by_kernel, prof_ms, _ = _device_profile(
            lambda: tf.forward(mcfg, params, batch))
    if busy_us <= 0:
        say("eval forward profile: torch.profiler recorded no device time on"
            " this machine, so device busy and idle share are not measured")
        return wall_ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    say(f"eval forward profile: bfloat16, on {smi}: wall {wall_ms:.2f} ms "
        f"({prof_ms:.1f} ms with the profiler on), device busy "
        f"{busy_us / 1e3:.2f} ms, device idle "
        f"{100 * (1 - busy_us / 1e3 / wall_ms):.1f}% of the forward; top "
        f"device ops by self time: " + "; ".join(
            f"{_short(name)[:90]} {us / 1e3:.2f} ms "
            f"({100 * us / busy_us:.1f}%)"
            for name, us in top))
    return wall_ms


def profile_round(dev, smi, train, ghost) -> None:
    """One steady-state round: float32 (as rounds 2 and on are), from the
    trained parameters, its arm built beforehand.  After a warm-up round
    (the allocator refills after the times phase), it runs once on the
    host clock and once more under ``torch.profiler``, which gives the
    device's busy time (the union of its kernels' intervals) and
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
    busy_us, by_kernel, prof_ms, spans = _device_profile(
        lambda: arms.LocalRunner().run(arm_again))
    # the row-sum kernel waits on the device for the tiles' grid, so the
    # union of both kernels' intervals, not the sum of their times
    ghost_us = _union_us((a, b) for name, a, b in spans
                         if "ghost_norm" in name) if spans else \
        sum(us for name, us in by_kernel.items() if "ghost_norm" in name)
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


def time_decode_step(engine, smi, position: int = SERVE_POSITION) -> None:
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


# -- 12. hot swap: phase 6's published rounds into a serving engine --------------


def _run_slots(engine, first, later, swap_after: int, watcher=None):
    """Admit ``first``, step ``swap_after`` times, then (with a watcher)
    poll it once, admit ``later`` and step until every request is done.
    Returns the poll's wall time in ms (None without a watcher)."""
    for r in first:
        if engine.admit(r):
            raise AssertionError(f"request {r.rid} ended at admission")
    for _ in range(swap_after):
        engine.step()
    swap_ms = None
    if watcher is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swapped = engine.poll_watcher(watcher)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        if not swapped:
            raise AssertionError("poll_watcher found no round to swap in")
    for r in later:
        if engine.admit(r):
            raise AssertionError(f"request {r.rid} ended at admission")
    while engine.busy():
        engine.step()
    return swap_ms


def _identical(a, b) -> bool:
    """Two parameter trees with the same keys, dtypes, shapes and bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _identical(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


def hot_swap_path(dev, smi, train, ckpt_dir: str) -> int:
    """Serve phase 6's published rounds: a float32 engine at round -1 swaps
    in the newest one mid-stream; returns the decode kernel's launches on
    that engine (the directly built engine it is held against runs first
    and does not count)."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    scfg = ServeConfig(arch=ARCH, smoke=False, slots=8, max_len=512,
                       temperature=0.0, seed=SEED, device=str(dev))
    last = list_rounds(ckpt_dir)[-1]
    if last != TRAIN["rounds"] - 1:
        raise AssertionError(f"newest published round {last}")
    final = train["params"]
    rng = np.random.default_rng(SEED + 12)
    prompts = rng.integers(0, mcfg.vocab_size, (8, 16)).astype(np.int32)
    budget, swap_after = 24, 4

    def requests(rows, start):
        return [Request(rid=start + i, arrival=0.0, prompt=prompts[i],
                        max_new_tokens=budget) for i in rows]

    # the yardstick: an engine built directly from phase 6's parameters,
    # the same requests in the same slots at the same steps
    direct = ServeEngine(scfg, model_cfg=mcfg, params=final)
    want = requests(range(4, 8), 4)
    _run_slots(direct, requests(range(4), 0), want, swap_after)
    del direct

    engine = ServeEngine(scfg, model_cfg=mcfg)      # seeded, round -1
    cache = {k: v.data_ptr() for k, v in engine.cache.items()}
    trace = generate_requests(TrafficConfig(rate=16, n_requests=16,
                                            vocab_size=mcfg.vocab_size,
                                            seed=SEED + 12))
    watcher = CheckpointWatcher(ckpt_dir)
    inflight, later = requests(range(4), 0), requests(range(4, 8), 4)
    decode_ops.reset_launches()
    swap_ms = _run_slots(engine, inflight, later, swap_after, watcher)
    result = run_open_loop(engine, trace, watcher=watcher)
    launches = decode_ops.launches()

    if engine.serving_round != last or engine.swaps != 1:
        raise AssertionError(f"serving round {engine.serving_round} after "
                             f"{engine.swaps} swaps, expected {last} after 1")
    if {k: v.data_ptr() for k, v in engine.cache.items()} != cache:
        raise AssertionError("the swap reallocated the KV cache")
    if not _identical(engine.params, final):
        raise AssertionError("the swapped parameters are not phase 6's "
                             "final ones bit for bit")
    short = [r.rid for r in inflight + later if len(r.tokens) != budget]
    if short:
        raise AssertionError(f"requests {short} ended short of their budget")
    if any(r.round_at_first != -1 for r in inflight) or \
            any(r.round_at_first != last for r in later):
        raise AssertionError("a request's first token came from the wrong "
                             "round")
    mismatched = [r.rid for r, w in zip(later, want) if r.tokens != w.tokens]
    if mismatched:
        raise AssertionError(f"greedy tokens after the swap differ from the "
                             f"directly built engine's for {mismatched}")
    done = sorted(r.rid for r in result.completed)
    if done != [r.rid for r in trace] or \
            any(len(r.tokens) != r.max_new_tokens for r in result.completed):
        raise AssertionError(f"{len(done)} of {len(trace)} watched requests "
                             "completed their budget")
    if not result.steps or any(
            (st.latest_round, st.serving_round) != (last, last)
            for st in result.steps) or result.swaps:
        raise AssertionError("the watched run did not serve the last round "
                             "throughout")
    positions = engine.decode_steps + sum(
        len(r.prompt) for r in inflight + later + trace)
    if launches != mcfg.n_layers * positions:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {mcfg.n_layers} x {positions} "
                             "positions")
    row = summarize(result, slots=8, rate=16)
    say(f"hot swap: {ARCH} untied head, full width float32, 8 slots x 512, "
        f"greedy: round -1 -> {last} after {swap_after} steps with 4 requests"
        f" in flight (each finished its {budget} tokens); swapped parameters "
        f"= phase 6's bit for bit; 4 requests admitted after the swap = the "
        f"directly built engine's tokens; watched trace of {len(trace)} "
        f"requests: all completed, latest_round = serving_round = {last} at "
        f"all {len(result.steps)} steps, {row['throughput_tok_s']} tok/s; "
        f"decode_attention launches {launches}")
    say(f"hot swap: load-and-swap (poll_watcher: read "
        f"{Path(checkpoint_path(ckpt_dir, last)).stat().st_size:,} bytes, "
        f"decode, copy to the card) {swap_ms:.2f} ms on {smi}")
    time_handoff(dev, smi, final, checkpoint_path(ckpt_dir, last))
    return launches


def time_handoff(dev, smi, params, path: str) -> None:
    """The publish and the load-and-swap in their parts, on the host clock
    (each synchronised): the parameters' copy to the host, the file's
    write from host tensors, the file's read and decode, and the copy of
    its tree to the card."""
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    host = timed("D2H copy", lambda: tree_map(
        lambda t: t.cpu(), params_to_tree(params)))
    spare = str(Path(path).with_name("timed.msgpack"))
    timed("write", lambda: save_checkpoint(spare, host, step=0))
    Path(spare).unlink()
    tree, _, _ = timed("read + decode", lambda: load_checkpoint(path))
    timed("H2D copy", lambda: params_from_tree(tree, dev))
    say(f"handoff parts: {', '.join(f'{k} {v:.2f} ms' for k, v in ms.items())}"
        f" ({Path(path).stat().st_size:,} bytes) on {smi}")


# -- main -----------------------------------------------------------------------


def main() -> int:
    smi = card()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build()
    worst = {"decode_attention": kernel_vs_plain(dev),
             "ghost_norm": ghost_vs_plain(dev),
             "flash_attention": flash_vs_plain(dev)}
    engine, launches = main_path(dev, smi)
    time_decode_step(engine, smi)
    del engine
    whole_path(dev)
    torch.cuda.empty_cache()
    ckpt = tempfile.TemporaryDirectory(prefix="ckpt-", dir=ROOT / "build")
    train = train_main_path(dev, smi, ckpt.name)
    launches["ghost_norm"] = train["launches"]
    train_whole_path(dev, train["silos"])
    torch.cuda.empty_cache()
    launches["flash_attention"] = eval_main_path(dev, smi, train["params"])
    torch.cuda.empty_cache()
    eval_whole_path(dev)
    torch.cuda.empty_cache()
    worst["flash_attention"] = max(worst["flash_attention"],
                                   eval_layers_bf16(dev))
    torch.cuda.empty_cache()
    blocked_train_path(dev)
    torch.cuda.empty_cache()
    times = {"decode_attention": time_decode(SERVE_SHAPE, dev, smi)}
    time_decode(SERVE_SHAPE, dev, smi, position=SERVE_POSITION)
    time_decode(LONG_SHAPE, dev, smi)
    ghost = time_ghost(dev, smi)
    times["ghost_norm"] = ghost["row"]
    profile_round(dev, smi, train, ghost)
    torch.cuda.empty_cache()
    times["flash_attention"] = time_flash(dev, smi)
    time_eval_forward(dev, smi, times["flash_attention"]["ms"])
    torch.cuda.empty_cache()
    launches["decode_attention"] += hot_swap_path(dev, smi, train, ckpt.name)
    ckpt.cleanup()
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

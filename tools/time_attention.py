#!/usr/bin/env python3
"""Time the port's attention kernels of one checkout on one CUDA card.

    python3 tools/time_attention.py [--src CHECKOUT] [--label NAME]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
two checkouts (a parent and a change) can be timed on one card by calling
the script once for each, in the order parent, change, change, parent.  It
calls only the public wrappers, whose signatures every version shares:

  * ``decode_attention`` in bfloat16 at the serving shape (B=8, L=512, 15
    query heads on 5 KV heads of 64) with every row at index 64 (where the
    serve path's positions lie) and at 511, and at L=4096, index 4095;
  * ``flash_attention`` in bfloat16 at B=8, S=L=2048, causal, at the
    evaluation heads (15 query heads on 5 KV heads of 64), at the same
    heads of 32 and at OLMo-1B's (16 on 16 of 128), each beside its bound
    (4 D operations per causal pair at 989 TFLOP/s), its plain version's
    time (``attention_plain``), one PyTorch library call's (causal
    ``scaled_dot_product_attention`` with ``enable_gqa``, a yardstick the
    port never calls) and its largest |kernel - plain| on one input; and
    the flash kernels' registers, shared memory and spills as ``ptxas -v``
    reported them.

Each time is the median over calls that rotate through enough input copies
that the L2 cache holds none of them, bracketed by CUDA events behind a
sleep kernel that holds the stream while the host enqueues.  Prints the
card's name and power limit, one line per measurement, and a JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

L2_BYTES = 50 * 2**20
DECODE_CASES = [(512, 64), (512, 511), (4096, 4095)]   # (L, index)
HEADS = dict(h=15, kv=5, d=64)
FLASH_HEADS = [(15, 5, 64), (15, 5, 32), (16, 16, 128)]   # (H, KV, D)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
# SDPA against the plain version in bf16 before it is timed (it may round
# P to bf16), as tests/test_kernels.py's limit
LIBRARY_TOL = 3e-2


def device_ms(fn, arg_sets, reps: int) -> float:
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[-1])
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 20_000_000 / a.elapsed_time(b)
    sleep = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    sleep[0].record()
    torch.cuda._sleep(int((3 * reps * one_ms + 20) * cycles_per_ms))
    sleep[1].record()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
        ev[i + 1].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if enqueue_ms >= sleep[0].elapsed_time(sleep[1]):
        raise RuntimeError("the enqueue outlasted the sleep: times would "
                           "include host gaps")
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def _randn(shape, g, dev, scale=1.0):
    return (scale * torch.randn(shape, generator=g, device=dev)).bfloat16()


def time_decode(ops, dev) -> list[dict]:
    b, h, kv, d = 8, HEADS["h"], HEADS["kv"], HEADS["d"]
    out = []
    for l, position in DECODE_CASES:
        copies = max(2, math.ceil(2 * L2_BYTES / (2 * b * l * kv * d * 2)))
        g = torch.Generator(device=dev).manual_seed(l)
        idx = torch.full((b,), position, dtype=torch.int32, device=dev)
        sets = [(_randn((b, 1, h, d), g, dev, 0.5),
                 _randn((b, l, kv, d), g, dev, 0.5),
                 _randn((b, l, kv, d), g, dev), idx) for _ in range(copies)]
        reps = max(30, 3 * copies)
        before = ops.launches()
        ms = device_ms(ops.decode_attention, sets, reps)
        if ops.launches() - before != reps + 2:
            raise AssertionError("decode_attention did not launch its kernel")
        out.append({"kernel": "decode_attention", "L": l, "index": position,
                    "ms": ms})
    return out


def _library_flash(q, k, v):
    # one PyTorch call for the same function (a yardstick only)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def time_flash(ops, ref, dev) -> list[dict]:
    b, s = 8, 2048
    out = []
    for h, kv, d in FLASH_HEADS:
        g = torch.Generator(device=dev).manual_seed(s + d)
        sets = [(_randn((b, s, h, d), g, dev), _randn((b, s, kv, d), g, dev),
                 _randn((b, s, kv, d), g, dev)) for _ in range(2)]

        def call(q, k, v):
            return ops.flash_attention(q, k, v, causal=True, block_q=s,
                                       block_k=s)

        q, k, v = sets[0]
        plain = ref.attention_plain(q, k, v, causal=True).float()
        diff = (call(q, k, v).float() - plain).abs()
        lib_err = float((_library_flash(q, k, v).float() - plain).abs().max())
        if not lib_err <= LIBRARY_TOL:
            raise AssertionError(f"SDPA disagrees with the plain version by "
                                 f"{lib_err:.3e}")
        ms = device_ms(call, sets, 20)
        plain_ms = device_ms(
            lambda q, k, v: ref.attention_plain(q, k, v, causal=True), sets, 6)
        library_ms = device_ms(_library_flash, sets, 20)
        bound_ms = 4 * d * b * h * s * (s + 1) / 2 / BF16_OPS_PER_S * 1e3
        out.append({"kernel": "flash_attention", "S": s, "H": h, "KV": kv,
                    "D": d, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "max_abs_err": float(diff.max()),
                    "mean_abs_plain": float(plain.abs().mean()),
                    "within_atol_1e-3_rtol_1e-2": bool(
                        torch.all(diff <= 1e-3 + 1e-2 * plain.abs()))})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    root = args.src.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    if not Path(decode_ops.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported repro_torch from {decode_ops.__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = time_decode(decode_ops, dev) + time_flash(flash_ops, flash_ref,
                                                     dev)
    rows += [{"ptxas": "flash_attention", **r}
             for r in build.resources("flash_attention")
             if "mma" in r["kernel"]]
    label = args.label or root.name
    for r in rows:
        print(f"{label}: " + ", ".join(f"{k}={v}" for k, v in r.items()))
    print(json.dumps({"label": label, "card": smi, "times": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

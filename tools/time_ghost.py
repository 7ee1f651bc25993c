#!/usr/bin/env python3
"""Time the port's ghost-norm kernel of one checkout on one CUDA card.

    python3 tools/time_ghost.py [--src CHECKOUT] [--label NAME]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
two checkouts (a parent and a change) can be timed on one card by calling
the script once for each, in the order parent, change, change, parent.  It
calls only the public wrapper ``ghost_norm(a, g)``, whose signature every
version shares, at SmolLM-360M's five training shapes (B=16 rows of S=256
tokens through the q/o, k/v, up/gate and down projections and the untied
head), in bfloat16 and in float32, at the training scales (activations of
unit scale, cotangents scaled so each example's norm^2 is about 1).  For
each it prints the median time, the largest relative difference of the
kernel from the plain version on one input and of each from a float64
reference there, and each participant's sum over a round (225 launches:
64, 64, 64, 32 and 1 of the five shapes).

Each time is the median over calls that rotate through enough input copies
that the L2 cache holds none of them, bracketed by CUDA events behind a
sleep kernel that holds the stream while the host enqueues (the timing of
``tools/time_attention.py``).  Prints the card's name and power limit, one
line per measurement, and a JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from time_attention import L2_BYTES, device_ms

# (b, s, d_in, d_out): launches per participant and round
SHAPES = {(16, 256, 960, 960): 64, (16, 256, 960, 320): 64,
          (16, 256, 960, 2560): 64, (16, 256, 2560, 960): 32,
          (16, 256, 960, 49152): 1}


def _inputs(b, s, d_in, d_out, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((b, s, d_in), generator=g, device=dev).to(dtype)
    cot = (torch.randn((b, s, d_out), generator=g, device=dev)
           / math.sqrt(s * d_in * d_out)).to(dtype)
    return a, cot


def _max_rel(x, ref) -> float:
    return float(((x.double() - ref) / ref).abs().max())


def time_shapes(ops, dev) -> list[dict]:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, ((b, s, d_in, d_out), count) in enumerate(SHAPES.items()):
            per_copy = b * s * (d_in + d_out) * dtype.itemsize
            copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
            sets = [_inputs(b, s, d_in, d_out, dtype, 300 + 10 * i + c, dev)
                    for c in range(copies)]
            a, g = sets[0]
            out, plain = ops.ghost_norm(a, g), ops.ghost_norm_blocked(a, g)
            ad, gd = a.double(), g.double()
            exact = (torch.einsum("bsd,btd->bst", ad, ad)
                     * torch.einsum("bsd,btd->bst", gd, gd)).sum(dim=(1, 2))
            del ad, gd
            reps = 20 if d_out > 10_000 else 40
            before = ops.launches()
            ms = device_ms(ops.ghost_norm, sets, reps)
            if ops.launches() - before != reps + 2:
                raise AssertionError("ghost_norm did not launch its kernel")
            rows.append({"dtype": str(dtype)[6:], "b": b, "s": s,
                         "d_in": d_in, "d_out": d_out, "ms": ms,
                         "max_rel_err": _max_rel(out, plain.double()),
                         "max_rel_err_f64": _max_rel(out, exact),
                         "plain_max_rel_err_f64": _max_rel(plain, exact),
                         "per_round": count})
            del sets, a, g
    return rows


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
    from repro_torch.kernels.ghost_norm import ops as ghost_ops
    if not Path(ghost_ops.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported repro_torch from {ghost_ops.__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = time_shapes(ghost_ops, dev)
    label = args.label or root.name
    for r in rows:
        print(f"{label}: " + ", ".join(f"{k}={v}" for k, v in r.items()))
    totals = {dt: sum(r["ms"] * r["per_round"] for r in rows
                      if r["dtype"] == dt) for dt in ("bfloat16", "float32")}
    print(f"{label}: per participant and round (225 launches) ms "
          + ", ".join(f"{dt} {ms:.4f}" for dt, ms in totals.items()))
    print(json.dumps({"label": label, "card": smi, "times": rows,
                      "per_participant_ms": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

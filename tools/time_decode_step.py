#!/usr/bin/env python3
"""Time the one-card decode step of one checkout on one CUDA card.

    python3 tools/time_decode_step.py [--src CHECKOUT] [--label NAME]
                                      [--arch A ...] [--repeats R]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
two checkouts (a parent and a change) can be timed on one card by calling
the script once for each, in turns.  For each arch (default SmolLM-360M,
Whisper-small and RWKV6-3B, at full width in bfloat16 with seeded random
weights and the decode kernel on) it builds 8 slots of cache and times
``transformer.decode_step_positions`` at ``chip_smoke.py``'s positions
(64 of 512; Whisper 16 of 24): five warm-up steps, then R medians of 20
steps each on the host clock (call + synchronise), as ``chip_smoke.py``'s
"decode step" line measures its host ms.  Prints the card's name and
power limit and one JSON line an arch.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (slots' max_len, position) as chip_smoke.py times each
SHAPES = {"smollm-360m": (512, 64), "whisper-small": (24, 16),
          "rwkv6-3b": (512, 64)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--src", default=str(ROOT))
    p.add_argument("--label", default="")
    p.add_argument("--arch", nargs="*", default=list(SHAPES))
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.src) / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    if not torch.cuda.is_available():
        sys.exit("time_decode_step: no CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for arch in args.arch:
        max_len, position = SHAPES[arch]
        cfg = get_config(arch).replace(use_decode_kernel=True)
        params = tf.init(cfg, 0, dev)
        cache = tf.init_cache(cfg, 8, max_len, dev)
        tokens = torch.zeros((8, 1), dtype=torch.int32, device=dev)
        positions = torch.full((8,), position, dtype=torch.int32,
                               device=dev)
        step = (cfg, params, cache, tokens, positions)
        for _ in range(5):
            tf.decode_step_positions(*step)
        torch.cuda.synchronize()
        medians = []
        for _ in range(args.repeats):
            host = []
            for _ in range(20):
                t0 = time.perf_counter()
                tf.decode_step_positions(*step)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            medians.append(round(statistics.median(host), 4))
        print(json.dumps({"label": args.label, "arch": arch,
                          "host_ms": medians, "card": smi}), flush=True)
        del params, cache, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Re-score dry-run records from their op logs (no tracing again).

Counterpart of ``repro.launch.reanalyze``, which re-reads the optimized
HLO cached beside each record.  A torch program has no HLO: the dry run
(``launch.dryrun``) caches beside each record the op log of what this
rank ran (``<record>.ops.jsonl.gz``: each distinct local op with its
argument and output shapes and dtypes and how many times it ran, and each
collective's kind and bytes).  ``reanalyze_file`` rebuilds the counts
from it: FLOPs by op through ``torch.utils.flop_counter``'s
``flop_registry`` on meta tensors of the logged shapes, collective bytes
and counts by kind, and the argument bytes from the record; then it
re-applies ``launch.roofline.roofline_terms`` and ``model_flops`` and
writes the record back.  A record nothing has changed since its trace
comes back with the trace's own numbers.

Usage: PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
from collections import Counter

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.shapes import apply_shape_overrides
from repro_torch.launch.dryrun import ARTIFACT_DIR, op_log_path
from repro_torch.launch.roofline import model_flops, roofline_terms


def _meta(spec):
    """Meta tensors of a logged [shape, dtype] (or a list of them)."""
    if spec is None:
        return None
    if isinstance(spec[0], list) and len(spec) == 2 and \
            isinstance(spec[1], str):
        return torch.empty(spec[0], dtype=getattr(torch, spec[1]),
                           device="meta")
    return [_meta(s) for s in spec]


def read_op_log(path: str) -> list[dict]:
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def counts_from_log(lines: list[dict]) -> dict:
    """FLOPs by op, and collective bytes and counts by kind, of one rank,
    from its op log."""
    packets = {str(p): p for p in flop_registry}
    flops, coll_bytes, coll_counts = Counter(), Counter(), Counter()
    for line in lines:
        name = line["op"].rsplit(".", 1)[0]    # aten.mm.default -> aten.mm
        if name in packets:
            args = [_meta(a) for a in line["args"]]
            flops[name] += line["n"] * flop_registry[packets[name]](
                *args, out_val=_meta(line["out"]))
        if "kind" in line:
            coll_counts[line["kind"]] += line["n"]
            coll_bytes[line["kind"]] += line["n"] * line["bytes"]
    return {"flops": flops, "coll_bytes": coll_bytes,
            "coll_counts": coll_counts}


def reanalyze_file(json_path: str) -> dict | None:
    """Re-score one record from its op log and write it back; None (and
    the record untouched) where it has no op log."""
    log = op_log_path(json_path)
    if not os.path.exists(log):
        return None
    with open(json_path) as f:
        rec = json.load(f)
    c = counts_from_log(read_op_log(log))
    n = rec["n_chips"]
    flops_rank = float(sum(c["flops"].values()))
    coll_rank = float(sum(c["coll_bytes"].values()))
    flops = flops_rank * n
    cfg = get_config(rec["arch"])
    if rec.get("cfg_overrides"):
        cfg = cfg.replace(**rec["cfg_overrides"])
    mf = model_flops(apply_shape_overrides(cfg, rec["shape"]),
                     INPUT_SHAPES[rec["shape"]], rec["kind"])
    rec.update(
        model_flops=mf,
        useful_flops_ratio=mf / flops if flops else None,
        flops=flops,
        flops_per_rank=flops_rank,
        flops_by_op_per_rank=dict(c["flops"].most_common()),
        collective_bytes=coll_rank * n,
        collective_bytes_per_rank=coll_rank,
        collective_by_kind={k: v * n for k, v in c["coll_bytes"].items()},
        collective_counts_per_rank=dict(c["coll_counts"]),
        roofline=roofline_terms(
            flops=flops, hbm_bytes=rec["argument_bytes_per_rank"] * n,
            coll_bytes=coll_rank * n, n_chips=n),
    )
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=ARTIFACT_DIR)
    args = p.parse_args(argv)
    n = 0
    for jp in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        rec = reanalyze_file(jp)
        if rec:
            n += 1
            r = rec["roofline"]
            print(f"{rec['arch']:20s} {rec['shape']:12s} {rec['mesh']:9s} "
                  f"cmp={r['compute_s']:.2e} mem={r['memory_s']:.2e} "
                  f"col={r['collective_s']:.2e} -> {r['bottleneck']}")
    print(f"reanalyzed {n} artifacts")


if __name__ == "__main__":
    main()

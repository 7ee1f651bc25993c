"""``python -m repro_torch.serve`` — one open-loop serving run.

Examples::

    # SmolLM-360M at full width on the card, seeded random weights
    python -m repro_torch.serve --full --slots 8 --max-len 512 --rate 16

    # smoke-scale model on the CPU
    python -m repro_torch.serve --device cpu --rate 4 --slots 4

    # serve while WATCHING a checkpoint directory someone else publishes to
    python -m repro_torch.serve --watch /tmp/ckpts --rate 2

    # the full loop in one process: a DeCaPH trainer thread publishes round
    # checkpoints that the engine hot-swaps mid-traffic
    python -m repro_torch.serve --train-rounds 6 --arm decaph --rate 4

The trainer thread runs on the engine's device (``--device``).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading

import repro_torch.obs as obs
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.handoff import CheckpointWatcher
from repro_torch.serve.metrics import render_markdown, summarize
from repro_torch.serve.traffic import TrafficConfig, generate_requests, run_open_loop


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="continuous-batching serving run (PyTorch / CUDA)",
    )
    p.add_argument("--arch", default="smollm-360m",
                   help="decoder-only arch name (repro_torch.configs)")
    p.add_argument("--rate", type=float, default=4.0,
                   help="mean Poisson arrival rate, requests/second")
    p.add_argument("--slots", type=int, default=4,
                   help="fixed decode-batch width")
    p.add_argument("--max-len", type=int, default=96,
                   help="per-slot KV capacity (prompt + generation)")
    p.add_argument("--requests", type=int, default=32,
                   help="number of arrivals to replay")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full", action="store_true",
                   help="full-width config instead of smoke scale")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the trainer runs there too")
    p.add_argument("--watch", default=None, metavar="DIR",
                   help="hot-swap checkpoints published into DIR")
    p.add_argument("--train-rounds", type=int, default=0, metavar="N",
                   help="also run an in-process federation trainer thread "
                        "publishing N rounds (into --watch, or a temp dir)")
    p.add_argument("--arm", default="decaph",
                   help="federation arm for --train-rounds")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the summary row as JSON")
    p.add_argument("--obs", default=None, metavar="DIR",
                   help="record obs spans/counters for the whole run and "
                        "export events + Chrome trace into DIR")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rec = obs.enable() if args.obs else None
    engine = ServeEngine(ServeConfig(
        arch=args.arch, slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, seed=args.seed, smoke=not args.full,
        device=args.device,
    ))
    watch_dir = args.watch
    trainer = None
    if args.train_rounds > 0:
        if watch_dir is None:
            watch_dir = tempfile.mkdtemp(prefix="repro-serve-ckpt-")
        from repro_torch.serve.federation import train_and_publish

        # the trainer MUST train the arch being served: hot-swap relies on
        # identical parameter shapes
        trainer = threading.Thread(
            target=train_and_publish,
            args=(args.arm, engine.model_cfg, watch_dir),
            kwargs={"rounds": args.train_rounds, "seed": args.seed,
                    "pace_s": 0.5, "device": args.device},
            daemon=True,
        )
        trainer.start()
        print(f"trainer: {args.arm} x {args.train_rounds} rounds "
              f"-> {watch_dir}")
    watcher = CheckpointWatcher(watch_dir) if watch_dir else None

    tcfg = TrafficConfig(rate=args.rate, n_requests=args.requests,
                         vocab_size=engine.model_cfg.vocab_size,
                         seed=args.seed)
    requests = generate_requests(tcfg)
    print(f"serving {args.arch} ({'full' if args.full else 'smoke'} scale) "
          f"on {engine.device}: {args.requests} requests @ {args.rate} q/s, "
          f"{args.slots} slots, max_len {args.max_len}")
    result = run_open_loop(engine, requests, watcher=watcher)
    if trainer is not None:
        trainer.join(timeout=60.0)
    row = summarize(result, slots=args.slots, rate=args.rate,
                    extra={"arch": args.arch, "device": str(engine.device)})
    print(render_markdown([row], title="repro_torch.serve — single run"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(row, f, indent=2)
        print(f"wrote {args.json}")
    if rec is not None:
        paths = obs.export(args.obs, rec)
        obs.disable()
        print(f"obs: wrote {', '.join(str(v) for v in paths.values())}")
    return 0

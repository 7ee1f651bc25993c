"""Static-batch serving CLI — a thin shim over ``repro_torch.serve``.

Counterpart of ``repro.launch.serve``: a one-command smoke of the decode
path.  The machinery lives in ``repro_torch.serve.ServeEngine``: each
prompt prefills in one program call (the decode step over its
positions, through the ``decode_attention`` kernel on the card) and every
generated token, the first included, is sampled at ``--temperature`` on
the device.  Encoder-decoders are refused, as the engine refuses them.

The prompts are seeded numpy draws (``default_rng(1)``), where the
reference draws them with ``jax.random.randint(key(1))``; the weights are
the engine's seeded init.

For continuous batching, open-loop traffic and live federation-checkpoint
hot swaps, use ``python -m repro_torch.serve``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 32 --gen 16 [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHITECTURES, get_smoke_config
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.serve.engine import ServeConfig, ServeEngine, batch_generate


def main(argv: list[str] | None = None) -> dict:
    """Serve one static batch; returns the ``engine``, its ``prompts``
    [B, prompt_len] and the generated ``tokens`` [B, gen]."""
    decoder_only = [a for a in ARCHITECTURES
                    if not get_smoke_config(a).is_encoder_decoder]
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", choices=decoder_only, default="smollm-360m")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    engine = ServeEngine(ServeConfig(
        arch=args.arch,
        slots=args.batch,
        max_len=args.prompt_len + args.gen,
        temperature=args.temperature,
        device=args.device,
    ))
    cfg = engine.model_cfg
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.time()
    gen = batch_generate(engine, prompts, args.gen)
    dt = time.time() - t0
    print(f"arch={args.arch} generated {gen.shape} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, "
          f"{engine.decode_dispatches + engine.admit_dispatches} dispatches)")
    print("sample tokens:", gen[0][:16].tolist())
    return {"engine": engine, "prompts": prompts, "tokens": gen}


if __name__ == "__main__":
    main()

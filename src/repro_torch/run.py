"""CLI: run any registered arm on any registered backend.

    python -m repro_torch.run --arm decaph --rounds 10
    python -m repro_torch.run --arm fl --backend sim
    python -m repro_torch.run --arm decaph --device cpu
    python -m repro_torch.run --list
    python -m repro_torch.run --smoke --device cpu   # every arm x backend

Counterpart of ``python -m repro.run``: logistic regression on GEMINI-like
hospitals (normalised by the cohort's global statistics), DP noise shares
behind SecAgg wherever the backend runs it, and the reference's result
line (with the simulated-time backend, ``sim``, on
``nodes_from_trace(heterogeneous_trace(hospitals))``, also its
``sim_wall`` part).  Both axes come from the registries (``arms.names()``,
``backends.backend_registry()``).  Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import repro_torch.arms as arms
import repro_torch.obs as obs
from repro_torch.arms import backends as backends_lib
from repro_torch.core.dp import DPConfig
from repro_torch.data.synthetic import make_gemini_like
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models.tabular import linear_model, pooled_accuracy
from repro_torch.sim.nodes import heterogeneous_trace, nodes_from_trace


def run_one(arm_name: str, backend: str, *, rounds: int, hospitals: int,
            features: int, examples: int, batch: int, seed: int,
            sigma: float, use_secagg: bool = True,
            device=DEFAULT_DEVICE) -> arms.RunReport:
    silos = arms.normalize_participants(
        make_gemini_like(seed=seed, n_total=examples, n_silos=hospitals,
                         n_features=features)
    )
    model = linear_model(features, device=device)
    cfg = arms.ArmConfig(
        rounds=rounds, batch_size=batch, lr=0.4, seed=seed,
        use_secagg=use_secagg,
        dp=DPConfig(clip_norm=1.0, noise_multiplier=sigma, microbatch_size=8),
    )
    nodes = None
    if backends_lib.get_backend(backend).info.supports_sim_time:
        nodes = nodes_from_trace(heterogeneous_trace(hospitals))
    report = arms.run(arm_name, model, silos, cfg, backend=backend,
                      nodes=nodes)
    report_acc = pooled_accuracy(model, report.params, silos)
    line = (f"{arm_name:<10} {backend:<5} rounds={report.rounds_completed:<4}"
            f" eps={report.epsilon:8.3f} loss={report.mean_loss():8.4f}"
            f" acc={report_acc:.3f}")
    if report.timing is not None:
        line += (f" | sim_wall={report.timing.wall_clock:9.3f}s"
                 f" wire={report.timing.bytes_on_wire:12.0f}B"
                 f" dropouts={report.timing.dropout_events}"
                 f" recoveries={report.timing.recoveries}")
    print(line)
    return report


def _smoke(device) -> int:
    """Every registered arm x every runnable registered backend."""
    failures = []
    registry = backends_lib.backend_registry()
    unavailable = {name: backends_lib.availability(name) for name in registry}
    for name, reason in unavailable.items():
        if reason:
            print(f"[smoke] backend {name!r} skipped here: {reason}",
                  file=sys.stderr)
    for name in arms.names():
        arm_cls = arms.get(name)
        for backend, info in registry.items():
            if unavailable[backend]:
                continue
            # negotiate: secure uploads only where the backend runs SecAgg
            use_secagg = info.supports_secagg
            ruled_out = backends_lib.compatibility_error(
                arm_cls, info, use_secagg=use_secagg)
            if ruled_out is not None:
                print(f"{name:<10} {backend:<5} ruled out: {ruled_out}")
                continue
            try:
                rep = run_one(
                    name, backend, rounds=3, hospitals=4, features=8,
                    examples=240, batch=32, seed=0, sigma=0.8,
                    use_secagg=use_secagg, device=device,
                )
                if rep.rounds_completed < 1:
                    raise RuntimeError("completed zero rounds")
            except Exception as e:  # noqa: BLE001 - smoke must report all
                failures.append(f"{name}/{backend}: {e}")
                print(f"{name:<10} {backend:<5} FAILED: {e}",
                      file=sys.stderr)
    if failures:
        print(f"\n{len(failures)} arm/backend smoke failures",
              file=sys.stderr)
        return 1
    print("\nall registered arms passed on every runnable backend")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.run",
        description="Run a registered federation arm on a registered "
                    "backend.",
    )
    p.add_argument("--arm", choices=arms.names(), help="arm to run")
    p.add_argument("--backend", choices=backends_lib.backend_names(),
                   default=backends_lib.DEFAULT_BACKEND)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--hospitals", type=int, default=5)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--examples", type=int, default=1200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma", type=float, default=0.8,
                   help="DP noise multiplier (private arms)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    p.add_argument("--list", action="store_true",
                   help="print registered arms + backends and exit")
    p.add_argument("--smoke", action="store_true",
                   help="every registered arm x every registered backend, "
                        "tiny shapes")
    p.add_argument("--obs", default=None, metavar="DIR",
                   help="record obs spans/counters + privacy ledger and "
                        "export events/ledger/Chrome trace into DIR")
    args = p.parse_args(argv)

    if args.list:
        print("arms:")
        for name in arms.names():
            cls = arms.get(name)
            print(f"  {name:<10} mode={cls.mode:<6} "
                  f"topology={cls.topology_kind:<5} private={cls.private}")
        print("backends:")
        for name, info in backends_lib.backend_registry().items():
            reason = backends_lib.availability(name)
            caps = (f"fused={info.supports_fused} "
                    f"secagg={info.supports_secagg} "
                    f"sim_time={info.supports_sim_time} "
                    f"group={info.bit_exact_group or '-'}")
            note = f"  [unavailable here: {reason}]" if reason else ""
            print(f"  {name:<10} {caps}{note}")
        return 0

    if args.smoke:
        return _smoke(args.device)

    if not args.arm:
        p.error("--arm is required (or use --list / --smoke)")
    rec = obs.enable() if args.obs else None
    try:
        run_one(args.arm, args.backend, rounds=args.rounds,
                hospitals=args.hospitals, features=args.features,
                examples=args.examples, batch=args.batch, seed=args.seed,
                sigma=args.sigma,
                use_secagg=backends_lib.get_backend(
                    args.backend).info.supports_secagg,
                device=args.device)
        if rec is not None:
            paths = obs.export(args.obs, rec)
            print(f"obs: wrote {', '.join(str(v) for v in paths.values())}")
    finally:
        if rec is not None:
            obs.disable()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

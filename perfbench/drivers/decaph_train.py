"""Kind ``decaph_train``: DeCaPH training rounds through the port's normal
path, ``repro_torch.arms.run("decaph", ...)`` on the ``ideal`` backend
with ghost clipping, SecAgg off.

Set-up makes the silos and the weights from the seed, builds the run and
drives its first ``followed_rounds`` rounds (round 0 in the weights'
bf16, round 1 the first in float32, as the SGD step promotes them); the
same run goes on into the window.  ``on_round`` synchronises the device
and times each round; once ``--seconds`` have run out it ends the run
through the protocol's own stop rule (a privacy budget of 0, which the arm
reads after every round).  The Poisson draws and the noise come from the
mix's fixed ``protocol_seed``, so every seed does the same real work in
the same order; the silos and the weights come from the seed.

Each window round but the last copies the weights it leaves into one
buffer, so that the weights before the last round are there when the
window closes.  After the window: the plain reference follows the first
rounds from the same weights and silos, and the window's last round from
the weights before it; the comparison reads the program's weights after
round 0, after the last followed round and after the last round.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from perfbench.harness import checks, generate
from perfbench.harness.port import model_config
from perfbench.harness.trace import Trace


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(job) -> dict:
    import repro_torch.arms as arms
    from repro_torch.core.dp import DPConfig
    from repro_torch.instrument import jit_dispatches, reset_jit_dispatches
    from repro_torch.serve.federation import transformer_model

    mc, mix, dev = job.mc, job.mix, torch.device(job.device)
    data = generate.token_silos(
        mc["vocab_size"], hospitals=mix["hospitals"], n_per=mix["n_per"],
        seq_len=mix["seq_len"], skew=mix["skew"],
        seed=generate.substream(job.seed, generate.DATA_STREAM))
    params0 = generate.make_params(mc, job.seed, dev)
    model = transformer_model(model_config(mc), device=dev)
    model = dataclasses.replace(model, init_fn=lambda _seed: params0)
    cfg = arms.ArmConfig(
        rounds=mix["max_rounds"], batch_size=mix["batch_size"], lr=mix["lr"],
        seed=mix["protocol_seed"], use_secagg=False, clipping="ghost",
        dp=DPConfig(clip_norm=mix["clip_norm"],
                    noise_multiplier=mix["noise_multiplier"]))
    followed = mix["followed_rounds"]
    length = min(job.seconds, mix["trace_seconds"]) if job.trace \
        else job.seconds
    tracer = Trace() if job.trace else None
    snaps: dict[int, list[torch.Tensor]] = {}
    st: dict = {}

    def on_round(t: int, params) -> None:
        _sync(dev)
        now = time.perf_counter()
        if t in (0, followed - 1):
            snaps[t] = [x.detach().clone() for x in generate.leaves(params)]
        if t == followed - 1:
            st["before"] = [x.clone() for x in snaps[t]]
            st["dtype"] = sorted({str(x.dtype).removeprefix("torch.")
                                  for x in generate.leaves(params)})
            if tracer is not None:
                tracer.start()
            reset_jit_dispatches()
            _sync(dev)
            st["start"] = time.perf_counter()
        elif "start" in st:
            if "end" in st:
                raise RuntimeError(f"round {t} ran after the window closed: "
                                   "the arm did not stop at its budget")
            if now - st["start"] >= length:
                st["end"], st["last"] = now, t
                st["dispatches"] = jit_dispatches()
                if tracer is not None:
                    tracer.stop()
                cfg.epsilon_budget = 0.0    # the arm stops after this round
            else:                           # the weights before round t + 1
                for b, x in zip(st["before"], generate.leaves(params)):
                    b.copy_(x)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    participants = [arms.Participant(x, y) for x, y in data]
    report = arms.run("decaph", model, participants, cfg, backend="ideal",
                      on_round=on_round)
    if "end" not in st:
        raise RuntimeError(f"the run ended after {report.rounds_completed} "
                           "rounds, before the window closed")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    logs = {log.round: log for log in report.logs}
    window = [logs[t] for t in range(followed, st["last"] + 1) if t in logs]
    real_rows = sum(log.aggregate_batch for log in window)
    failed = sum(log.aggregate_batch > 0 and not math.isfinite(log.loss)
                 for log in window)
    if not all(bool(torch.isfinite(x).all())
               for x in generate.leaves(report.params)):
        failed = max(failed, 1)
    window_s = st["end"] - st["start"]
    out = {
        "setup_s": st["start"] - job.t_start,
        "attempted": len(window),
        "failed": failed,
        "memory_peak_bytes": peak,
        "end_to_end": {
            "train_tokens_per_s": real_rows * mix["seq_len"] / window_s},
        "ctx": {"mc": mc, "mix": mix, "window_s": window_s,
                "rounds": len(window), "real_rows": real_rows,
                "seq_len": mix["seq_len"], "param_dtype": st["dtype"],
                "dispatches": st["dispatches"],
                "trace": tracer.summary if tracer else None},
        "notes": [f"parameters during the window: {', '.join(st['dtype'])}",
                  f"window: {len(window)} rounds, {real_rows} real rows, "
                  f"{window_s:.6f} s"],
    }
    last = st["last"]
    prog = {"loss": [logs[t].loss for t in range(followed)],
            "agg": [logs[t].aggregate_batch for t in range(followed)]}
    prog_last = {"loss": [logs[last].loss],
                 "agg": [logs[last].aggregate_batch]}
    before, after = st.pop("before"), generate.leaves(report.params)
    del report, model, logs, window
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_mod, lr, pseed = job.reference, mix["lr"], mix["protocol_seed"]
    p0 = generate.leaves(params0)
    before_tree = generate.like(params0, before)

    def first(**kw):
        return ref_mod.follow(mc, mix, params0, data, pseed, rounds=followed,
                              **kw)

    def final(**kw):
        return ref_mod.follow(mc, mix, before_tree, data, pseed, rounds=1,
                              start=last, **kw)

    # one comparison at a time, each freeing what it held before the next;
    # ``frozen`` is the program's weights left as they were
    frozen = "frozen" in job.variants
    ref = first()
    prog.update(checks.program_steps(p0, snaps[0], snaps[followed - 1], ref,
                                     lr))
    frozen_first = frozen and {**prog, **checks.program_steps(p0, p0, p0, ref,
                                                               lr)}
    del snaps, ref["noise1"], ref["noise_change"]
    ref_last = final()
    prog_last.update(checks.program_steps(before, after, after, ref_last, lr))
    frozen_last = frozen and {**prog_last, **checks.program_steps(
        before, before, before, ref_last, lr)}
    del after, ref_last["noise1"], ref_last["noise_change"]
    out["numbers"] = checks.all_numbers(
        checks.train_numbers(prog, ref),
        checks.last_round_numbers(prog_last, ref_last))
    out["readings"] = {
        "program": {"loss": prog["loss"] + prog_last["loss"],
                    "agg": prog["agg"] + prog_last["agg"]},
        "reference": {"loss": ref["loss"] + ref_last["loss"],
                      "agg": ref["agg"] + ref_last["agg"]},
        "rounds": list(range(followed)) + [last]}
    out["variants"] = {}
    if frozen:
        out["variants"]["frozen"] = checks.all_numbers(
            checks.train_numbers(frozen_first, ref),
            checks.last_round_numbers(frozen_last, ref_last))
    plain = ref_mod.plain
    kw = {"fp8": {"mm": plain.fp8_mm}, "tf32": {"mm": plain.tf32_mm},
          "bf16": {"mm": plain.bf16_mm}, "half": {"half": True}}
    for name in (v for v in job.variants if v in kw):
        out["variants"][name] = checks.all_numbers(
            checks.train_numbers(first(**kw[name]), ref),
            checks.last_round_numbers(final(**kw[name]), ref_last))
    return out

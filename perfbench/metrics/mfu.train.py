"""``mfu.train`` (%): model FLOPs of the window's real tokens (6 N T, N the
weights of every dense product with the untied head, plus causal
attention, 6 L S h hd a token) over the window's time and the chip's bf16
peak, whatever precision the step runs in."""

from perfbench.harness.work import PEAK_FLOPS, train_flops


def read(ctx: dict) -> float | None:
    if not ctx.get("window_s"):
        return None
    tokens = ctx["real_rows"] * ctx["seq_len"]
    flops = train_flops(ctx["mc"], tokens, ctx["seq_len"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS["bfloat16"])

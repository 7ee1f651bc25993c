"""``mfu.eval`` (%): one forward's model FLOPs over the window's tokens (2 N
T, N the weights of every dense product with the head, plus causal
attention, 2 L S h hd a token) over the window's time and the chip's bf16
peak."""

from perfbench.harness.work import PEAK_FLOPS, eval_flops


def read(ctx: dict) -> float | None:
    if not ctx.get("window_s"):
        return None
    flops = eval_flops(ctx["mc"], ctx["tokens"], ctx["seq_len"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_FLOPS["bfloat16"])

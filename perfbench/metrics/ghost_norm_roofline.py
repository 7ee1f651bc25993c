"""``ghost_norm_roofline`` (%): the least time the chip could take for the
ghost norms of the window's real rows, over the device time of the
ghost-norm kernels in the traced window.

The work comes from the configuration's dense widths and the sequence
length (``harness.work.ghost_gram_seconds``): the pad rows a Poisson batch
is filled with are not counted, so the share rises when less padding is
computed.  Float32 operands (the weights after round 0) are held to the
3xTF32 rate, bf16 to the tensor cores' peak."""

from perfbench.harness.work import ghost_gram_seconds

KERNELS = ("ghost_norm_tiles", "ghost_norm_combine", "ghost_norm_rows")


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if trace is None:
        return None
    device_s = trace.device_seconds(*KERNELS)
    if device_s <= 0:
        return None
    dtype = "float32" if "float32" in ctx["param_dtype"] else "bfloat16"
    least = ghost_gram_seconds(ctx["mc"], ctx["real_rows"], ctx["seq_len"],
                               dtype)
    return 100.0 * least / device_s

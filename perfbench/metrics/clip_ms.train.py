"""``clip_ms.train`` (ms/round): the device's busy time inside the port's
``clip`` spans (one a hospital and round around its clipped gradient sum:
the ghost norm pass and the clip-weighted pass, ``arms/decaph.py``), per
window round.  The spans' intervals are on the device's clock (CUDA
events), the busy time the profiler's.  Read from a
``harness.spans.SpanTrace`` summary; nothing without one or without the
span."""


def read(ctx: dict) -> float | None:
    by_span = getattr(ctx.get("trace"), "device_s_by_span", None) or {}
    if "clip" not in by_span or not ctx.get("rounds"):
        return None
    return 1e3 * by_span["clip"] / ctx["rounds"]

"""``idle_share.train`` (%): the share of the traced window in which no
operation ran on the device (the union of the device intervals in the
profiler's trace)."""


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

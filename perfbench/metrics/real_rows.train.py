"""``real_rows.train`` (%): the rows the window's Poisson draws held over
the rows the cohort steps computed, pad rows included: 100 x ``rows.real``
/ ``rows.computed``, the port's own counters (``arms/fused.py``
``stack_poisson``).  Read from a ``harness.spans.SpanTrace`` summary;
nothing without one or without the counters."""


def read(ctx: dict) -> float | None:
    counters = getattr(ctx.get("trace"), "counters", None) or {}
    computed = counters.get("rows.computed")
    if not computed:
        return None
    return 100.0 * counters.get("rows.real", 0.0) / computed

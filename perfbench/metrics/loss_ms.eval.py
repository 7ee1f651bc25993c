"""``loss_ms.eval`` (ms/batch): the device's busy time inside the port's
``model.loss`` spans (``models/transformer.py`` ``loss_fn``: the float32
cast of the logits, their logsumexp and the gathered labels' logits), per
window batch.  The spans' intervals are on the device's clock (CUDA
events), the busy time the profiler's.  Read from a
``harness.spans.SpanTrace`` summary; nothing without one or without the
span."""


def read(ctx: dict) -> float | None:
    by_span = getattr(ctx.get("trace"), "device_s_by_span", None) or {}
    if "model.loss" not in by_span or not ctx.get("batches"):
        return None
    return 1e3 * by_span["model.loss"] / ctx["batches"]

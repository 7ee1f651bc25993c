"""``round_calls.train`` (calls/round): the port's instrumented program
calls (``repro_torch.instrument.jit_dispatches``) over the window, per
round.  The DeCaPH arm's contract is one fused cohort step a round."""


def read(ctx: dict) -> float | None:
    if not ctx.get("rounds"):
        return None
    return ctx["dispatches"] / ctx["rounds"]

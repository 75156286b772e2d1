"""device_ms_per_step.4card (step): ms a step in which a kernel other
than a cross-card flag wait ran, on the card where that is longest."""


def read(ctx):
    if ctx.trace is None:
        return None
    work = lambda name: "flag_kernel" not in name  # noqa: E731
    return max(ctx.per_step_ms(ctx.trace.union_s(c, work))
               for c in ctx.cards)

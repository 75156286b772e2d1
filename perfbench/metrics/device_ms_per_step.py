"""device_ms_per_step (step): ms a step in which a kernel ran on the
card (the union of kernel intervals, over the stretch's steps)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.per_step_ms(ctx.trace.union_s(ctx.card))

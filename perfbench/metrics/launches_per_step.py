"""launches_per_step (step): kernels that ran on the card a step."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches(ctx.card) / ctx.trace.steps

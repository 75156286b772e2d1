"""host_launch_calls_per_step (step loop): the host's kernel launch and
graph replay calls (kernel_classes.HOST_LAUNCH_CALLS) a step."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.host_calls() / ctx.trace.steps

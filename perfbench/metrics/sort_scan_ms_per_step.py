"""sort_scan_ms_per_step (particles): ms a step of the sort / scan kernel
class (the re-sort and the compactions), their union on the card."""
from perfbench.trace import class_pred


def read(ctx):
    if ctx.trace is None:
        return None
    pred = class_pred("sort / scan")
    if ctx.trace.kernel_s(ctx.card, pred)[1] == 0:
        return None
    return ctx.per_step_ms(ctx.trace.union_s(ctx.card, pred))

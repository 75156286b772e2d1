"""deposit_prep_launches_per_step (particles): kernels a step in the
program's ``deposit`` device span other than K1's and K3's (what
deposit_prep_ms_per_step times), counted."""
from perfbench.metrics._spans import not_deposit_kernel, span_kernels


def read(ctx):
    iv = span_kernels(ctx, ("deposit",), not_deposit_kernel)
    if iv is None:
        return None
    return len(iv) / ctx.trace.steps

"""deposit_prep_ms_per_step (particles): ms a step of the kernels in the
program's ``deposit`` device span other than K1's and K3's -- the
deposit's geometry and operands, and the ring species' sorts -- their
union on the card."""
from perfbench.metrics._spans import not_deposit_kernel, span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("deposit",), not_deposit_kernel)

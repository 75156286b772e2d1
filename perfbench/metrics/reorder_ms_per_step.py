"""reorder_ms_per_step (particles): ms a step of the kernels in the
program's ``reorder`` device span -- the resident re-sort, banded or
full, and its padded payload -- their union on the card."""
from perfbench.metrics._spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("reorder",))

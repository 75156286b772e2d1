"""copy_back_ms_per_step (step loop): ms a step of the kernels in the
program's ``row`` and ``store`` device spans -- the read of a step's
row of the chunk runner's table, which opens the replayed step, and the
copy of its result into the runner's static buffers, the captures, the
step index -- their union on the card."""
from perfbench.metrics._spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("row", "store"))

"""exchange_ms_per_step (step): ms a step, over all the stretch's
steps, of the kernels in the program's ``exchange`` device span -- the
exchange block of every exchange period: removal, injection, a fresh
rho_prev -- their union on the card."""
from perfbench.metrics._spans import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("exchange",))

"""graph_gap_ms_per_step (device): ms a step in which the card was idle
inside a replayed step: between the first marker of a step (``row``,
before the step's table read) and the end of its ``store`` span's last
kernel, no kernel (markers included) ran.  The gaps inside a graph;
those between graphs, up to the next step's first marker, are left
out."""
from perfbench.metrics._spans import idle_inside, step_windows


def read(ctx):
    windows = step_windows(ctx)
    if windows is None:
        return None
    return ctx.per_step_ms(idle_inside(ctx, windows) * 1e-6)

"""idle_share (device): percent of the traced stretch's wall time in
which no kernel ran on the card (1 - union of kernel intervals / wall)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.union_s(ctx.card) / ctx.trace.wall_s)

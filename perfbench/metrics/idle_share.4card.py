"""idle_share.4card (device): percent of the traced stretch's wall time
in which no kernel ran on a card, the cross-card flag waits
(flag_kernel, which spin while a card waits for a peer) counted as idle,
averaged over the cards."""


def read(ctx):
    if ctx.trace is None:
        return None
    work = lambda name: "flag_kernel" not in name  # noqa: E731
    idle = [1.0 - ctx.trace.union_s(c, work) / ctx.trace.wall_s
            for c in ctx.cards]
    return 100.0 * sum(idle) / len(idle)

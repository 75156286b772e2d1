"""rollback_share (step loop): percent of the window's step() calls
whose chunk the program ran again eagerly (its
overflow_totals["rollbacks"] over the calls)."""


def read(ctx):
    if ctx.chunks == 0:
        return None
    return 100.0 * ctx.rollbacks / ctx.chunks

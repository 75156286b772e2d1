"""peer_wait_ms_per_step (parallel): ms a step that the cross-card flag
waits (csrc/peer.cu's flag_kernel) spin, on the card that waits most."""


def read(ctx):
    if ctx.trace is None:
        return None
    wait = lambda name: "flag_kernel" in name  # noqa: E731
    if not any(ctx.trace.kernel_s(c, wait)[1] for c in ctx.cards):
        return None
    return max(ctx.per_step_ms(ctx.trace.union_s(c, wait))
               for c in ctx.cards)

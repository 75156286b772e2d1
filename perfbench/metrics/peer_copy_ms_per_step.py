"""peer_copy_ms_per_step (parallel): ms a step of the cross-card copies
(csrc/peer.cu's copy_parts_kernel), on the card that waits most for its
peers (where peer_wait_ms_per_step is read)."""


def read(ctx):
    if ctx.trace is None:
        return None
    wait = lambda name: "flag_kernel" in name  # noqa: E731
    copy = lambda name: "copy_parts_kernel" in name  # noqa: E731
    if not any(ctx.trace.kernel_s(c, copy)[1] for c in ctx.cards):
        return None
    card = max(ctx.cards, key=lambda c: ctx.trace.union_s(c, wait))
    return ctx.per_step_ms(ctx.trace.union_s(card, copy))

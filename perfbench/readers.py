"""What the per-layer metric readers (metrics/<name>.py) share.

A reader gets a ``Context`` and returns a number, or None where it
finds nothing to read (no trace, no such kernel on the path, a card
without published peaks); the harness then leaves the metric out."""
from dataclasses import dataclass

from . import peaks, registry


@dataclass
class Context:
    """What a traced run gives its readers.  ``trace``: the traced
    stretch (trace.Trace) or None; ``cards``: the indices of the cards
    the run uses; ``chunks`` / ``rollbacks``: step() calls of the window
    and those the program ran again (its ``overflow_totals
    ["rollbacks"]``); ``grid``: the configuration's physical Nz, Nr, Nm;
    ``live``: the live macroparticles during the stretch (the mean of
    the reads before and after it); ``kind``: the cards' name."""
    trace: object
    cards: list
    chunks: int
    rollbacks: int
    grid: dict
    live: float
    kind: str

    @property
    def card(self):
        """The card of a one-card cell."""
        return self.cards[0]

    def busiest(self):
        """The card on which kernels ran longest in the stretch."""
        return max(self.cards, key=lambda c: self.trace.union_s(c))

    def per_step_ms(self, seconds):
        return seconds * 1e3 / self.trace.steps


def roofline_share(ctx, kernel):
    """Percent of its roofline that ``kernel`` (roofline/<kernel>.py)
    reached in the stretch: the least time of its work (the larger of
    bytes over the HBM rate and operations over the float32 rate), over
    the time its launches took, on the card."""
    card = peaks.peak(ctx.kind)
    if ctx.trace is None or card is None:
        return None
    counter = registry.roofline(kernel)
    took, n = ctx.trace.kernel_s(ctx.card, lambda name: counter.KERNEL in name)
    if n == 0 or took <= 0:
        return None
    n_bytes, n_flops = counter.work(ctx.grid, ctx.live)
    least, _ = peaks.least_seconds(n_bytes, n_flops, card)
    return 100.0 * least * ctx.trace.steps / took

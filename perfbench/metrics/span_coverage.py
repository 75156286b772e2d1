"""span_coverage (device): percent of the card's busy time, markers
left out, that lies in a named device span of the program (after its
first marker)."""
from perfbench.metrics._spans import by_span
from perfbench.trace import union_us


def read(ctx):
    parts = by_span(ctx)
    if parts is None:
        return None
    every = [(s, e) for iv in parts.values() for s, e, _ in iv]
    named = [(s, e) for sp, iv in parts.items() if sp is not None
             for s, e, _ in iv]
    total = union_us(every)
    return 100.0 * union_us(named) / total if total > 0 else None

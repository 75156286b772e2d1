"""What the step-phase readers share: the card's kernels partitioned by
the program's device spans.

The program launches an empty marker kernel ``fbpic_span_<name>`` where
each span of a step or of a step() call begins
(fbpic_tpu_torch/utils/profiling.py); a span lasts until the card's
next marker.  Every other kernel on the card belongs to the span of the
latest marker that started before it (to none before the first).  A
trace without a marker (a program without spans) gives None."""
from collections import defaultdict

from perfbench.trace import merged, union_us

MARKER = "fbpic_span_"
#: The spans a step() call opens from the host, outside its steps
CALL_SPANS = ("prepare", "chunk_in", "chunk_out")
#: The deposit kernels (K1, K3), which deposit_prep leaves out
DEPOSIT_KERNELS = ("fused_contract_kernel", "dense_contract_kernel")


def is_marker(name):
    return name.startswith(MARKER)


def _sorted(ctx):
    """The card's kernels in start order, or None without a marker."""
    if ctx.trace is None:
        return None
    ks = sorted(ctx.trace.kernels.get(ctx.card, ()))
    if not any(is_marker(n) for _, _, n in ks):
        return None
    return ks


def by_span(ctx):
    """{span: [(start us, end us, name)]} of the card's kernels other
    than markers (span None: before the first marker), or None."""
    ks = _sorted(ctx)
    if ks is None:
        return None
    out, cur = defaultdict(list), None
    for s, e, n in ks:
        if is_marker(n):
            cur = n[len(MARKER):]
        else:
            out[cur].append((s, e, n))
    return out


def span_kernels(ctx, spans, pred=None):
    """(start, end) of the kernels in ``spans`` (those whose name
    ``pred`` takes), or None."""
    parts = by_span(ctx)
    if parts is None:
        return None
    return [(s, e) for sp in spans for s, e, n in parts.get(sp, ())
            if pred is None or pred(n)]


def span_ms_per_step(ctx, spans, pred=None):
    """ms a step of the union of the kernels in ``spans`` (those whose
    name ``pred`` takes) on the card, or None."""
    iv = span_kernels(ctx, spans, pred)
    if iv is None:
        return None
    return ctx.per_step_ms(union_us(iv) * 1e-6)


def not_deposit_kernel(name):
    return not any(k in name for k in DEPOSIT_KERNELS)


def step_windows(ctx):
    """(start us, end us) of each step on the card that ends in a
    ``store`` span (a replayed step): from its first marker (the
    program's ``row``, which opens each replayed step) to the end of the
    last kernel of its ``store`` span; or None.  The time between a
    step's last kernel and the next step's first marker, the launch of
    the next graph, lies in no window."""
    ks = _sorted(ctx)
    if ks is None:
        return None
    windows, start, end = [], None, None
    for s, e, n in ks:
        if not is_marker(n):
            if end is not None:
                end = max(end, e)
            continue
        name = n[len(MARKER):]
        if end is not None:
            windows.append((start, end))
            start = end = None
        if name in CALL_SPANS:
            start = None
        elif name == "store":
            if start is not None:
                end = e
        elif start is None:
            start = s
    if end is not None:
        windows.append((start, end))
    return windows


def idle_inside(ctx, windows):
    """Microseconds of ``windows`` (sorted, disjoint) in which no
    kernel, marker or other, ran on the card."""
    busy = merged([(s, e) for s, e, _ in ctx.trace.kernels.get(ctx.card,
                                                                ())])
    idle, j = 0.0, 0
    for ws, we in windows:
        while j < len(busy) and busy[j][1] <= ws:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < we:
            covered += min(we, busy[k][1]) - max(ws, busy[k][0])
            k += 1
        idle += (we - ws) - covered
    return idle

"""The traced stretch: torch.profiler over whole chunks of the window,
its events held in memory (no trace file is written), reduced to what
the per-layer readers take.

Busy time is the union of the kernel intervals on a card (overlapping
streams count once), never a sum of kernel times; the idle share is
1 - busy / the stretch's wall time."""
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from .kernel_classes import HOST_LAUNCH_CALLS, kernel_class

#: An idle gap shorter than this lies between two kernels of one launch
#: or graph; longer ones are named by what the host was doing
GAP_NAMED_US = 5.0


@dataclass
class Trace:
    """One traced stretch.  ``kernels``: per card index, (start us, end
    us, name) of every kernel; ``host``: (start us, end us, name) of
    every host event; ``wall_s``: the stretch's host wall time, from
    before its first call to after its synchronize; ``steps``: steps in
    the stretch."""
    kernels: dict
    host: list
    wall_s: float
    steps: int

    def cards(self):
        return sorted(self.kernels)

    def union_s(self, card, pred=None):
        """Seconds in which a kernel (of those whose name ``pred`` takes)
        ran on ``card``."""
        iv = [(s, e) for s, e, n in self.kernels.get(card, ())
              if pred is None or pred(n)]
        return union_us(iv) * 1e-6

    def kernel_s(self, card, pred):
        """Summed duration of the kernels ``pred`` takes on ``card``, and
        their count."""
        ks = [(e - s) for s, e, n in self.kernels.get(card, ()) if pred(n)]
        return sum(ks) * 1e-6, len(ks)

    def launches(self, card):
        return len(self.kernels.get(card, ()))

    def host_calls(self, names=HOST_LAUNCH_CALLS):
        return sum(1 for _, _, n in self.host if n in names)


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    if not intervals:
        return 0.0
    a = np.array(sorted(intervals), dtype=np.float64)
    total, cur_s, cur_e = 0.0, a[0, 0], a[0, 1]
    for s, e in a[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return total + cur_e - cur_s


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def traced(run, steps, cards):
    """Run ``run()`` (whole chunks of ``steps`` steps) under
    torch.profiler, ending in a synchronize of each of ``cards``; the
    Trace of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        for c in cards:
            torch.cuda.synchronize(c)
        wall = time.perf_counter() - t0
    kernels, host = defaultdict(list), []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == cuda:
            kernels[ev.device_index].append((tr.start, tr.end, ev.name))
        else:
            host.append((tr.start, tr.end, ev.name))
    return Trace(dict(kernels), host, wall, steps)


def breakdown(trace, card, top=10):
    """``device_ops``: the kernels that took most time on ``card``
    (summed by name); ``idle_gaps``: the idle time between its kernels,
    summed by what the host was doing (the innermost host event around
    the gap's middle), gaps under GAP_NAMED_US together."""
    by_name = defaultdict(float)
    for s, e, n in trace.kernels.get(card, ()):
        by_name[n[:120]] += (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged([(s, e) for s, e, _ in trace.kernels.get(card, ())])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    host = sorted(trace.host)
    starts = np.array([h[0] for h in host])
    idle = defaultdict(float)
    for s, e in gaps:
        dur = e - s
        if dur < GAP_NAMED_US:
            idle[f"between kernels (< {GAP_NAMED_US:g} us)"] += dur * 1e-6
            continue
        mid = 0.5 * (s + e)
        k = int(np.searchsorted(starts, mid, side="right"))
        around = [h for h in host[max(0, k - 200):k] if h[1] >= mid]
        name = (min(around, key=lambda h: h[1] - h[0])[2][:120] if around
                else "no traced host event")
        idle[name] += dur * 1e-6
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gap_list]}


def class_pred(*classes):
    """A predicate on kernel names: whether the name's class is one of
    ``classes`` (kernel_classes.py)."""
    wanted = set(classes)
    return lambda name: kernel_class(name) in wanted

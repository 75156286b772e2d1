"""Tracing / profiling hooks (fbpic_tpu/utils/profiling.py).

``trace`` records a torch.profiler trace of a code block (host
activity, and the CUDA kernels when CUDA is present) and writes it into
``logdir`` as a Chrome / Perfetto trace; ``section`` times a host-side
block on the wall clock, waiting for the device's queued work first.

Usage::

    from fbpic_tpu_torch.utils.profiling import trace
    with trace("fbpic-trace"):
        sim.step(100)
    # then open fbpic-trace/trace.json at ui.perfetto.dev
"""
import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir):
    """torch.profiler trace around a code block, written to
    ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def section(name, sink=print):
    """Wall-clock timer for a host-side section.  Where CUDA was
    initialised it waits for the queued device work before the clock
    stops (a device error surfaces here); on the CPU every op has run
    when it returns."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        sink(f"[fbpic_tpu_torch] {name}: "
             f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

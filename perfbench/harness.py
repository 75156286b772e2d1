"""One run of one cell: set-up, the measured window, the traced stretch
and the comparison with the plain reference that decides ``correct``.

The window is a sequence of ``step(chunk_steps)`` calls of the
program's entry (``Simulation.step``, or ``DistributedRun.step`` for a
cell on slabs), each ending in the benchmark's own read of the live
macroparticles (one synchronize a call and card), until ``seconds``
have passed.  ns_per_particle_step is the wall time of the whole calls
over the sum, over their steps, of the live macroparticles (each call's
steps counted at the mean of the reads before and after it).  With
``trace`` one call of the window (``trace_chunk``) runs under
torch.profiler; that run reports the per-layer metrics.

``correct`` (compare.py, checks/<workload>.json): the check follows
``check_exchange_periods`` exchange periods of steps twice.  The start:
the program's states after its first such steps (in set-up) are copied
to the host, and the plain reference (reference/plain_pic: eager, its
slabs on one card), built from the same configuration and seed, follows
the same steps from its own initial state (its own plasma loading and
laser).  The end: once the window has closed and the memory peak is
read, the program's state is copied to the host, the program runs the
same number of steps more through the same entry, its result is copied
too and the program is freed; the reference follows those steps from
the program's copied state (generator states included).  Each result
is held against the reference's.  Lost particles (a column, ring or
migration overflow) make a run not correct."""
import contextlib
import gc
import math
import sys
import time

import torch

from . import compare, program, reference, registry
from .readers import Context
from .runner import Runner

#: Top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "fbpic_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: fbpic_tpu_torch is not fbpic_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


@contextlib.contextmanager
def tf32(on):
    """float32 matmuls in TF32 (the control's precision) while on."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def dtype_of(cfg):
    return {"float32": torch.float32, "float64": torch.float64}[
        cfg["precision"]]


def random_seed(seed):
    """The configuration's random_seed from the run's --seed (numpy's
    seeds, with the port's +987654321 offset, must stay below 2**32)."""
    return int(seed) % 2**31


def run_window(run, seconds, traffic, trace):
    """The measured window (module docstring) on Runner ``run``.
    Returns its numbers and the traced stretch (or None)."""
    from . import trace as tracing
    chunk = int(traffic["chunk_steps"])
    trace_at = int(traffic.get("trace_chunk", 1))
    live_before = run.live()
    calls, steps, particle_steps, failed = 0, 0, 0.0, 0
    traced, traced_live = None, None
    base = run.counters()
    t0 = time.perf_counter()
    while True:
        tc = time.perf_counter()
        before = run.counters()
        if trace and calls == trace_at:
            traced = tracing.traced(lambda: run.step(chunk), chunk,
                                    run.cards)
        else:
            run.step(chunk)
        live_after = run.live()
        after = run.counters()
        dt = time.perf_counter() - tc
        calls += 1
        steps += chunk
        particle_steps += chunk * 0.5 * (live_before + live_after)
        if traced is not None and traced_live is None:
            traced_live = 0.5 * (live_before + live_after)
        if after != before:
            failed += chunk
        log(f"chunk {calls}: {chunk} steps in {dt:.4f} s, live "
            f"{live_after}, counters {after}, ended at {time.time():.3f}")
        live_before = live_after
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    end = run.counters()
    return dict(wall_s=wall, calls=calls, steps=steps,
                particle_steps=particle_steps, failed=failed,
                rollbacks=end["rollbacks"] - base["rollbacks"],
                traced=traced, traced_live=traced_live)


def reference_run(build, cfg, rseed, devices, dtype):
    """The plain reference's run of the configuration: its slabs, if it
    has them, all on the first device, stepped by the eager loop."""
    ref = Runner(build(reference.api(), cfg, rseed,
                       [devices[0]] * len(devices), dtype))
    if ref.slabs:
        ref.obj.eager = True
    return ref


def followed(build, cfg, rseed, devices, dtype, k_steps, snap=None,
             control=False):
    """The reference's states after ``k_steps`` steps from its own
    initial state, or from the snapshot ``snap`` of the program's run;
    in TF32 with ``control``."""
    with tf32(control):
        ref = reference_run(build, cfg, rseed, devices, dtype)
        if snap is not None:
            ref.restore(snap, reference.PACKAGE)
        ref.step(k_steps)
        ref.sync()
        return ref.snapshot()["states"]


def check(run, cfg, rseed, devices, dtype, k_steps, start, limits,
          control=False):
    """The compared numbers of the run (module docstring) and the
    detail behind them.  ``start``: the host copy of the program's
    states after its first ``k_steps`` steps.  ``control``: the
    reference in TF32 takes the program's place."""
    build = registry.builder(cfg).build
    snap = run.snapshot()
    grid = run.moment_grid()
    run.step(k_steps)
    run.sync()
    P = run.snapshot()["states"]
    lost = run.lost()
    del run
    gc.collect()
    if torch.device(devices[0]).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    args = (build, cfg, rseed, devices, dtype, k_steps)
    R0, R = followed(*args), followed(*args, snap)
    if control:
        start, P, lost = followed(*args, control=True), \
            followed(*args, snap, control=True), 0
    log(f"reference: built and followed {k_steps} steps twice in "
        f"{time.perf_counter() - t0:.2f} s")
    g0 = compare.gaps(start, R0, grid)
    g = compare.gaps(P, R, grid)
    values = dict(eb_gap=g["eb_gap"], position_gap=g["position_gap"],
                  start_eb_gap=g0["eb_gap"],
                  start_position_gap=g0["position_gap"],
                  lost_particles=lost)
    detail = dict(step=g["detail"], start=g0["detail"], recorded={
        k: gg[n] for k, gg, n in (
            ("j_rho_gap", g, "j_rho_gap"), ("momentum_gap", g, "momentum_gap"),
            ("start_j_rho_gap", g0, "j_rho_gap"),
            ("start_momentum_gap", g0, "momentum_gap"))})
    ok = all(math.isfinite(v) and v <= limits[k]["limit"]
             for k, v in values.items())
    # a reading that is not a finite number (a NaN field, another shape)
    # is printed as the largest float: the result stays valid JSON
    checks = {k: dict(value=v if math.isfinite(v) else sys.float_info.max,
                      limit=limits[k]["limit"])
              for k, v in values.items()}
    return ok, checks, detail


def run_cell(bench, wl, seed, seconds, trace, *, t_start, devices,
             cfg=None, traffic=None, limits=None, control=False):
    """One run of cell ``wl`` (a workloads entry) on ``devices`` (one a
    chip).  ``cfg``, ``traffic`` and ``limits`` replace the
    configuration's values, the traffic mix's and the cell's limits (the
    tests' small sizes).  Returns the result object (without the
    device's name and count, which the caller adds) or raises."""
    cfg = cfg or registry.config(wl["config"])
    traffic = traffic or registry.traffic(wl["traffic"])
    limits = limits or registry.checks(wl["name"])
    dtype = dtype_of(cfg)
    rseed = random_seed(seed)
    cards = [torch.device(d) for d in devices
             if torch.device(d).type == "cuda"]
    if cards:
        torch.cuda.init()
        torch.cuda.set_device(cards[0])
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)

    build = registry.builder(cfg).build
    run = Runner(build(program.api(), cfg, rseed, list(devices), dtype))
    k_steps = int(traffic["check_exchange_periods"]) * run.exchange_period
    warmup = int(traffic["warmup_steps"])
    if warmup < k_steps:
        raise ValueError(f"the warm-up ({warmup} steps) is shorter than "
                         f"the steps the check follows ({k_steps})")
    # the start: the program's first steps, which the reference follows
    # from its own initial state
    run.step(k_steps)
    start = run.snapshot()["states"]
    run.step(warmup - k_steps)
    run.sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.3f} s ({traffic['warmup_steps']} warm-up "
        f"steps, {run.graph_variants()} graph variants, {run.live()} "
        f"live)")

    win = run_window(run, seconds, traffic, trace and bool(cards))
    run.sync()
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=None)
    log(f"window: {win['calls']} calls, {win['steps']} steps in "
        f"{win['wall_s']:.4f} s, {run.graph_variants()} graph variants, "
        f"rollbacks {win['rollbacks']}, peak memory {peak}")
    grid = run.grid()
    run_cards = run.cards
    jax_loaded = forbidden_modules()

    ok, checks, detail = check(run, cfg, rseed, list(devices), dtype,
                               k_steps, start, limits, control=control)
    del run
    result = dict(correct=ok and not jax_loaded, attempted=win["steps"],
                  failed=win["failed"], metrics={},
                  device=dict(memory_peak_bytes=peak))
    quantities = dict(
        ns_per_particle_step=win["wall_s"] * 1e9 / win["particle_steps"],
        peak_mem_gib=None if peak is None else peak / 2**30,
        setup_s=setup_s)
    if not trace:
        for m in registry.end_to_end(bench, wl["name"]):
            v = quantities.get(m["name"].split(".", 1)[0])
            if v is not None:
                result["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
    else:
        tr = win["traced"]
        ctx = Context(trace=tr, cards=run_cards, chunks=win["calls"],
                      rollbacks=win["rollbacks"], grid=grid,
                      live=win["traced_live"] or 0.0,
                      kind=torch.cuda.get_device_name(run_cards[0])
                      if run_cards else "cpu")
        for m in registry.per_layer(bench, wl["name"]):
            v = registry.metric_reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = dict(value=v, unit=m["unit"])
        if tr is not None:
            from .trace import breakdown
            result["device"]["busy_s"] = sum(
                tr.union_s(c) for c in run_cards) / len(run_cards)
            result["device"]["window_s"] = tr.wall_s
            result["breakdown"] = breakdown(tr, ctx.busiest())
    result["_detail"] = detail
    result["_forbidden"] = jax_loaded
    result["checks"] = checks
    return result

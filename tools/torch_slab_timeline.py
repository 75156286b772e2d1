"""The host's timeline of the graphed slabs' chunk on the card.

examples/multichip_lwfa_script.py at full width on 2 slabs of cuda:0
(chip_smoke.py phase 24's run: float32, seeded, the slabs' chunk
runner, its migration and exchange block replayed inside the graphs).
For step(N) calls of N = 30 (phase 24's timed window) and 98 steps,
each starting one step after a diagnostic period (so that no diagnostic
is written inside), twice each, after the same schedule ran once
untimed (its graph variants are captured there; a measured call that
still captures one lists it):

- the call's wall time on the host and its parts, in order: the chunk
  runner's set-up before the first replay (each slab's plan of the
  chunk, ``ChunkBuffers._plan``; the tables' upload, ``_upload``; the
  rest: the states copied into the static buffers), the replays' host
  issue time, the chunk's one read (``SlabMultiStep._read``, which waits
  for the card), what follows the read in the runner (the states copied
  out of the static buffers) and what ``DistributedRun.step`` does
  around the runner;
- the card's time from the first replay's launch to the last one's end
  (CUDA events on the stream), and the device busy of the same call
  length (torch.profiler, kernel time summed, one more call);
- the idle share of the call, 1 - busy / wall, and how the card's idle
  time splits: before the first replay (the set-up), between the
  replays (the card's span less their busy time) and after the last
  (the read's return to the call's end).

Run on the card from the repository root:

    python3 tools/torch_slab_timeline.py

It prints the card's name and power limit first, and its numbers as one
JSON object on the last line.
"""
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def instrument(events, owner, name):
    """Wrap ``owner.name`` to append (name, host start, host end) to
    ``events`` at every call; returns the original."""
    real = getattr(owner, name)

    @functools.wraps(real)
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            events.append((name, t0, time.perf_counter()))
    setattr(owner, name, call)
    return real


def device_busy_ms(run, n_steps):
    """Kernel time summed over one run.step(n_steps) call, torch.profiler
    (None when it records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run.step(n_steps)
        torch.cuda.synchronize()
    busy_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3 if busy_us else None


def to_start(run, period):
    """Steps to one past the next diagnostic period (the measured call
    then writes nothing)."""
    while run.iteration % period != 1:
        run.step((1 - run.iteration) % period or period)


def main():
    import torch
    import chip_smoke
    from fbpic_tpu_torch.core.graph import ChunkBuffers
    from fbpic_tpu_torch.parallel import api, domain
    from fbpic_tpu_torch.utils import kernels
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    kernels.build_all()
    real_dist = api.distribute_simulation
    ns = chip_smoke.multichip_script(
        lambda sim, **kw: chip_smoke.Deferred(real_dist(
            sim, devices=["cuda:0"] * 2, **kw)), [])
    run = ns["run"].run
    period = ns["sim"].diags[0].period
    blockers = run.graph_blockers
    print(f"graph_blockers {blockers}; exchange period "
          f"{run.exchange_period}; diagnostic period {period}", flush=True)
    if any(blockers):
        raise RuntimeError("the slabs do not replay whole steps")
    # The measured schedule once untimed: its calls capture their graph
    # variants here
    schedule = (30, 98, 30, 98)
    for n in schedule:
        to_start(run, period)
        run.step(n)
    torch.cuda.synchronize()

    events = []
    reals = [(owner, name, instrument(events, owner, name))
             for owner, name in ((api.DistributedRun, "step"),
                                 (domain.SlabMultiStep, "__call__"),
                                 (ChunkBuffers, "_plan"),
                                 (ChunkBuffers, "_upload"),
                                 (domain.SlabMultiStep, "_graphed"),
                                 (domain.SlabMultiStep, "_read"))]
    marks = {}
    graphed = domain.SlabMultiStep._graphed

    def graphed_marked(self, *args, **kwargs):
        if "first" not in marks:
            marks["first"] = torch.cuda.Event(enable_timing=True)
            marks["first"].record()
        out = graphed(self, *args, **kwargs)
        marks["last"] = torch.cuda.Event(enable_timing=True)
        marks["last"].record()
        return out
    domain.SlabMultiStep._graphed = graphed_marked

    results = []
    try:
        for n in schedule:
            to_start(run, period)
            torch.cuda.synchronize()
            events.clear()
            marks.clear()
            it0 = run.iteration
            before = set(run.runner.graphs)
            run.step(n)
            torch.cuda.synchronize()
            captured = sorted(set(run.runner.graphs) - before)
            ev = {}
            for name, a, b in events:
                ev.setdefault(name, []).append((a, b))
            (t0, t_end), = ev["step"]
            (c0, c1), = ev["__call__"]
            replays = ev["_graphed"]
            (r0, r1), = ev["_read"]
            wall = 1e3 * (t_end - t0)
            first = 1e3 * (replays[0][0] - t0)
            m = dict(
                n_steps=n, from_iteration=it0, chunks=len(ev["__call__"]),
                captured=[list(v) for v in captured],
                wall_ms=wall, ms_per_step=wall / n,
                before_runner_ms=1e3 * (c0 - t0),
                plan_ms=1e3 * sum(b - a for a, b in ev["_plan"]),
                upload_ms=1e3 * sum(b - a for a, b in ev["_upload"]),
                first_replay_at_ms=first,
                replays=len(replays),
                replay_issue_ms=1e3 * (replays[-1][1] - replays[0][0]),
                read_wait_ms=1e3 * (r1 - r0),
                after_read_in_runner_ms=1e3 * (c1 - r1),
                after_runner_ms=1e3 * (t_end - c1),
                after_read_ms=1e3 * (t_end - r1),
                replay_span_device_ms=marks["first"].elapsed_time(
                    marks["last"]))
            m["copy_in_and_rest_of_setup_ms"] = (
                first - m["before_runner_ms"] - m["plan_ms"]
                - m["upload_ms"])
            results.append(m)
        for m in results[:2]:
            to_start(run, period)
            busy = device_busy_ms(run, m["n_steps"])
            for r in results:
                if r["n_steps"] == m["n_steps"]:
                    r["device_busy_ms_per_step"] = (
                        None if busy is None else busy / m["n_steps"])
    finally:
        domain.SlabMultiStep._graphed = graphed
        for owner, name, real in reals:
            setattr(owner, name, real)
    for m in results:
        busy = m.get("device_busy_ms_per_step")
        if busy is not None:
            n = m["n_steps"]
            m["idle_share"] = 1 - busy * n / m["wall_ms"]
            m["idle_ms"] = m["wall_ms"] - busy * n
            m["idle_between_replays_ms"] = (m["replay_span_device_ms"]
                                            - busy * n)
        print(f"step({m['n_steps']}) from iteration {m['from_iteration']} "
              f"({m['chunks']} chunk, {m['replays']} replays, graphs "
              f"captured in it {m['captured']}), {smi}: "
              f"{m['ms_per_step']:.4f} ms/step ({m['wall_ms']:.2f} ms), "
              f"device busy {busy} ms/step, idle share "
              f"{m.get('idle_share')} ({m.get('idle_ms')} ms)", flush=True)
        print(f"  first replay issued at {m['first_replay_at_ms']:.2f} ms: "
              f"before the runner {m['before_runner_ms']:.2f}, plan "
              f"{m['plan_ms']:.2f}, upload {m['upload_ms']:.2f}, copy-in "
              f"and the rest {m['copy_in_and_rest_of_setup_ms']:.2f}; "
              f"replays issued in {m['replay_issue_ms']:.2f} ms, run by the "
              f"card in {m['replay_span_device_ms']:.2f} ms (idle between "
              f"them {m.get('idle_between_replays_ms')} ms); read waits "
              f"{m['read_wait_ms']:.2f} ms; after the read "
              f"{m['after_read_ms']:.2f} ms (runner "
              f"{m['after_read_in_runner_ms']:.2f}, DistributedRun.step "
              f"{m['after_runner_ms']:.2f})", flush=True)
    variants = [list(v) for v in sorted(run.runner.graphs)]
    run.runner.release()
    print(json.dumps(dict(device=smi, variants=variants, calls=results)))


if __name__ == "__main__":
    main()

"""The host's timeline of the graphed slabs on the card.

examples/multichip_lwfa_script.py at full width on 2 slabs of cuda:0
(chip_smoke.py phase 24's run: float32, seeded, the slabs' chunk
runner), after a 30-step warm-up:

- one step(98) call, 7 exchange periods: when each exchange block (the
  slab threads' eager migration, removal, injection and fresh rho_prev,
  ``SlabGroup.run``) started and ended on the host, and the chunk's
  read, against the call's start;
- one exchange block alone, with the card idle and behind an ~80 ms
  sleep kernel: its host time, the CUDA runtime calls by host time
  (torch.profiler), and the host time of the block's parts on each slab
  (the migration, the injection, the rho_prev deposit, the copy into
  the static buffers): the part that waits for the card is where the
  block's commands fill the card's command queue.

Run on the card from the repository root:

    python3 tools/torch_slab_timeline.py
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from fbpic_tpu_torch.core import step as step_mod
    from fbpic_tpu_torch.core.graph import ChunkBuffers
    from fbpic_tpu_torch.parallel import api, domain
    from fbpic_tpu_torch.utils import kernels
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    kernels.build_all()
    real_dist = api.distribute_simulation
    ns = chip_smoke.multichip_script(
        lambda sim, **kw: chip_smoke.Deferred(real_dist(
            sim, devices=["cuda:0"] * 2, **kw)), [])
    run = ns["run"].run
    run.step(30)
    torch.cuda.synchronize()
    runner = run.runner
    events = []

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            events.append((name, t0, time.perf_counter()))
            return out
        return call
    group_run = runner.group.run
    runner.group.run = timed("exchange block", group_run)
    runner._read = timed("chunk read", runner._read)
    parts = []

    def timed_part(owner, name):
        real = getattr(owner, name)

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            parts.append((getattr(kernels.current_slab, "rank", None), name,
                          t0, time.perf_counter()))
            return out
        setattr(owner, name, call)
        return real
    reals = [(owner, name, timed_part(owner, name)) for owner, name in (
        (domain, "migrate_particles"), (step_mod, "continuous_injection"),
        (step_mod, "deposit_rho_spect"), (ChunkBuffers, "_store"))]

    n = 7 * run.exchange_period
    torch.cuda.synchronize()
    events.clear()
    t0 = time.perf_counter()
    run.step(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"step({n}) from iteration {run.iteration - n}: "
          f"{wall * 1e3 / n:.4f} ms/step ({wall * 1e3:.1f} ms)")
    for name, a, b in events:
        print(f"  {name:15s} {1e3 * (a - t0):9.2f} .. {1e3 * (b - t0):9.2f} "
              f"ms ({1e3 * (b - a):.2f} ms)")
    sleep_cycles = int(1.98e9 * 0.08)     # the H100's 1.98 GHz boost clock
    for label, cycles in (("the card idle", 0),
                          ("behind an ~80 ms sleep kernel", sleep_cycles)):
        while run.iteration % run.exchange_period:
            run.step(1)
        torch.cuda.synchronize()
        events.clear()
        parts.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            if cycles:
                torch.cuda._sleep(cycles)
            run.step(1)
            torch.cuda.synchronize()
        block = [b - a for name, a, b in events if name == "exchange block"]
        print(f"one exchange block, {label}: {1e3 * block[0]:.2f} ms on "
              f"the host")
        rows = sorted((ev for ev in prof.key_averages()
                       if ev.key.startswith("cu")),
                      key=lambda ev: -ev.self_cpu_time_total)
        for ev in rows[:4]:
            print(f"  {ev.key:24s} {ev.count:6d} calls, "
                  f"{ev.self_cpu_time_total / 1e3:8.2f} ms")
        for rank, name, a, b in sorted(parts, key=lambda p: p[2]):
            if rank is not None:
                print(f"  slab {rank} {name:22s} {1e3 * (a - t0):9.2f} .. "
                      f"{1e3 * (b - t0):9.2f} ms ({1e3 * (b - a):.2f} ms)")
    runner.group.run = group_run
    for owner, name, real in reals:
        setattr(owner, name, real)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device-busy time and kernel launches per step of the two paths that
chip_smoke.py drives (the bench LWFA and the boosted-frame LWFA), for
the tree in the current directory.

Run from the root of a checkout on a machine with an NVIDIA GPU; to
compare two trees on one card, run it in each in turn (first, second,
second, first) inside one job:

    cd tree_a && python3 /path/to/tools/torch_profile_paths.py
    cd tree_b && python3 /path/to/tools/torch_profile_paths.py

It imports chip_smoke and fbpic_tpu_torch from the current directory,
builds that tree's kernels, and for each path steps 5 times to warm up,
times 60 unprofiled steps on the host clock (synchronized), then
profiles 10 steps with torch.profiler (chip_smoke.profile_steps: the sum
of the kernel rows is the busy time of the one stream).  Prints one
line `PROFILE {...}` per path.
"""
import json
import os
import sys
import time


def run(name, sim, cs, torch):
    sim.step(cs.N_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(cs.N_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / cs.N_TIMED * 1e3
    prof = cs.profile_steps(sim, cs.N_PROFILED)
    if any(sim.overflow_totals.values()):
        raise RuntimeError(f"{name}: overflow {sim.overflow_totals}")
    print("PROFILE " + json.dumps(dict(path=name, tree=os.getcwd(),
                                       ms_per_step=ms, **(prof or {}))),
          flush=True)


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from fbpic_tpu_torch.utils import kernels
    kernels.build_all()
    run("bench LWFA", cs.make_sim(), cs, torch)
    torch.cuda.empty_cache()
    run("boosted LWFA", cs.make_boosted_sim(), cs, torch)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device-busy time and kernel launches per step of the paths that
chip_smoke.py drives (the bench LWFA, the boosted-frame LWFA, and the
published boosted script from its empty box: the ring path), for the
tree in the current directory.

Run from the root of a checkout on a machine with an NVIDIA GPU; to
compare two trees on one card, run it in each in turn (first, second,
second, first) inside one job:

    cd tree_a && python3 /path/to/tools/torch_profile_paths.py
    cd tree_b && python3 /path/to/tools/torch_profile_paths.py

Arguments pick the paths (`lwfa`, `boosted`, `ring`; default: all).

It imports chip_smoke and fbpic_tpu_torch from the current directory,
builds that tree's kernels, and for each path steps 5 times to warm up
(the ring path first steps until its plasma fills the box),
times 60 unprofiled steps on the host clock (synchronized), then
profiles 10 steps with torch.profiler: the profile_steps of the
chip_smoke.py beside this script (the sum of the kernel rows is the busy
time of the one stream; the rows of the port's kernels, K1-K3, by name),
and the host synchronizations of one more step (its count_syncs), so
both trees are read by the same code.  Prints one line `PROFILE {...}`
per path.
"""
import importlib.util
import json
import os
import sys
import time
from pathlib import Path


def measures():
    """The chip_smoke.py next to this script, as a module."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("smoke_measures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(name, sim, cs, torch, n_warm=None):
    sim.step(n_warm or cs.N_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(cs.N_TIMED)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / cs.N_TIMED * 1e3
    here = measures()
    prof = here.profile_steps(sim, cs.N_PROFILED)
    syncs = here.count_syncs(sim, name)
    if any(sim.overflow_totals.values()):
        raise RuntimeError(f"{name}: overflow {sim.overflow_totals}")
    print("PROFILE " + json.dumps(dict(path=name, tree=os.getcwd(),
                                       ms_per_step=ms, host_syncs=syncs,
                                       **(prof or {}))), flush=True)


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from fbpic_tpu_torch.utils import kernels
    kernels.build_all()
    paths = sys.argv[1:] or ["lwfa", "boosted", "ring"]
    if "lwfa" in paths:
        run("bench LWFA", cs.make_sim(), cs, torch)
        torch.cuda.empty_cache()
    if "boosted" in paths:
        run("boosted LWFA", cs.make_boosted_sim(), cs, torch)
        torch.cuda.empty_cache()
    if "ring" in paths:
        sim = cs.make_boosted_sim(p_zmin_lab=cs.B_P_ZMIN_PUBLISHED)
        run("published boosted (ring)", sim, cs, torch,
            n_warm=cs.ring_fill_steps(sim)[0])


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""fbpic_tpu's injection angles of the golden-wake run, for the card.

tests/test_golden_wake.py pins fbpic_tpu's float64 run of a small LWFA
(Nz = 400, Nr = 24, open z, moving window, continuous injection, a0 = 1)
at 100 and 450 steps (tests/data/golden_wake.npz).  The port reproduces
those profiles only with fbpic_tpu's injection angles, which come from
jax.random; the card machine has no JAX.  This script runs the port's
float64 resident step on the CPU through the 450 steps with fbpic_tpu's
angles (tests/test_torch_step.py::jax_column_angles), records every
call of the angle source -- its iteration, species, column keys and
angles -- into tests/data/torch_golden_angles.npz, and prints the run's
profiles against the golden (pin_* at 100 steps, full_* at 450), each
relative to its profile's largest value.

Run from the root of a checkout (JAX on the CPU, float64):

    JAX_PLATFORMS=cpu python3 tools/torch_golden_angles.py [--out PATH]

About 2 minutes on 4 CPU threads.  tests/test_torch_golden.py checks the
file against fbpic_tpu's draws; chip_smoke.py and tests/test_torch_cuda.py
feed it to the card.
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "tests", "data", "torch_golden_angles.npz"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch
    torch.set_num_threads(4)
    from test_torch_golden import golden_config_sim, profiles
    from test_torch_step import jax_column_angles
    sim = golden_config_sim()
    angles = jax_column_angles(sim.device_seed, torch.float64)
    calls = []

    def recorded(iteration, species_index, nkey):
        phi = angles(iteration, species_index, nkey)
        calls.append((int(iteration), int(species_index),
                      nkey.cpu().numpy().copy(), phi.numpy().copy()))
        return phi

    sim.column_angles = recorded
    gold = np.load(os.path.join(REPO, "tests", "data", "golden_wake.npz"))
    errs = {}
    for horizon, n in (("pin", 100), ("full", 350)):
        sim.step(n)
        for name, arr in profiles(sim).items():
            g = gold[f"{horizon}_{name}"]
            errs[f"{horizon}_{name}"] = float(
                np.abs(arr - g).max() / np.abs(g).max())
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    np.savez_compressed(
        args.out, seed=np.int64(sim.device_seed),
        iteration=np.array([c[0] for c in calls], np.int64),
        species=np.array([c[1] for c in calls], np.int64),
        nkey=np.stack([c[2] for c in calls]),
        angles=np.stack([c[3] for c in calls]))
    print(json.dumps(dict(calls=len(calls), out=os.path.relpath(
        args.out, REPO), profile_errors=errs)))


if __name__ == "__main__":
    main()

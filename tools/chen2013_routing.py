#!/usr/bin/env python3
"""Where the per-level electrons of tests/test_ionization.py's Chen 2013
case go: the weight each level's electron species holds at the end,
against the weight of the ions that passed that level, and (the port
only) the weight the open z boundary removed from it.

Run from the root of a checkout:

    python3 tools/chen2013_routing.py fbpic_tpu      [--steps N]
    python3 tools/chen2013_routing.py fbpic_tpu_torch [--steps N] [--device cuda]

The configuration is the test's (N2+ ionized up to N6+ by an a0 = 1.8
laser given as an external field; 401 x 3 cells, open z, 1681 steps),
in float64 on the CPU unless --device says otherwise.  Each level's
electrons that reach the guard cells of the open z boundary are removed
at an exchange step, so the species ends with less than its ions' weight
unless the removed weight is added back.  The port's removal is counted
by chip_smoke.py's counted_removal (the gate of its Chen 2013 phase).
Prints one JSON line per level.  On an 8-core CPU fbpic_tpu takes ~4
minutes, the port ~13 (four threads).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def configure(package, device):
    if package == "fbpic_tpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as xp
        from fbpic_tpu import Simulation
        from fbpic_tpu.lpa_utils import ExternalField
        return xp, Simulation, ExternalField, {}
    import torch
    torch.set_num_threads(4)
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils import ExternalField
    return torch, Simulation, ExternalField, dict(device=device,
                                                  dtype=torch.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("fbpic_tpu", "fbpic_tpu_torch"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    xp, Simulation, ExternalField, kw = configure(args.package, args.device)
    from scipy.constants import c, e, m_e, m_p

    zmin_lab, zmax_lab, Nr, rmax, Nm = 0.e-6, 20.e-6, 3, 10.e-6, 2
    plasma = dict(p_nz=2, p_nr=1, p_nt=4, p_zmin=5.e-6, p_zmax=15.e-6,
                  p_rmin=0., p_rmax=100.e-6, continuous_injection=False)
    n_atoms, a0, lambda0 = 0.2, 1.8, 0.8e-6
    ctau = 10. * lambda0
    z0 = -2 * ctau
    E0 = a0 * m_e * c * (2 * np.pi * c / lambda0) / e

    def laser_func(F, x, y, z, t, amplitude, length_scale):
        return F + amplitude * xp.cos(2 * np.pi * (z - c * t) / lambda0) \
            * xp.exp(-((z - c * t - z0) ** 2) / ctau**2)

    dz = lambda0 / 16.
    Nz = int((zmax_lab - zmin_lab) / dz) + 1
    N_step = int((2. * 40. * lambda0 + zmax_lab - zmin_lab) / dz) + 1
    if args.steps:
        N_step = args.steps
    sim = Simulation(Nz, zmax_lab, Nr, rmax, Nm, dz / c, zmin=zmin_lab,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, **kw)
    sim.add_new_species(q=-e, m=m_e, n=2 * n_atoms, **plasma)
    ions = sim.add_new_species(q=0, m=14. * m_p, n=n_atoms, **plasma)
    targets = {lvl: sim.add_new_species(q=-e, m=m_e, capacity=65536,
                                        continuous_injection=False)
               for lvl in range(2, 6)}
    ions.make_ionizable(element="N", level_start=2, level_max=6,
                        target_species=targets)
    sim.external_fields = [ExternalField(laser_func, "Ex", E0, 0.),
                           ExternalField(laser_func, "By", E0 / c, 0.)]
    removed = None
    t0 = time.perf_counter()
    if args.package == "fbpic_tpu_torch":
        from chip_smoke import counted_removal
        with counted_removal(len(sim.state.species)) as removed:
            sim.step(N_step, use_true_rho=True)
    else:
        sim.step(N_step, use_true_rho=True)
    seconds = time.perf_counter() - t0

    def host(a):
        return np.asarray(a.cpu() if hasattr(a, "cpu") else a)
    sp = sim.state.species[ions._index]
    w, lev = host(sp.w).astype(np.float64), host(sp.ionization_level)
    live = w != 0
    print(json.dumps(dict(package=args.package, steps=N_step,
                          seconds=seconds, n5_fraction=float(
                              w[live & (lev == 5)].sum() / w[live].sum()))))
    for lvl, view in targets.items():
        tw = float(host(sim.state.species[view._index].w)
                   .astype(np.float64).sum())
        through = float(w[live & (lev > lvl)].sum())
        row = dict(level=lvl, target_weight=tw, ions_through=through,
                   ratio=tw / through if through else None)
        if removed is not None:
            gone = float(sum(r.item() for r in removed[view._index]))
            row.update(removed_at_boundary=gone,
                       rel_gap_net_of_removed=(tw + gone - through)
                       / through if through else None)
        print(json.dumps(row))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Two CPU checks behind the LPA-utility notes of PERF.md and ROADMAP.md.

Run from the root of a checkout:  python3 tools/lpa_cpu_checks.py

1. What fbpic_tpu's curl-free current correction does to a laser
   emitted by an antenna: tests/test_antenna.py's configuration (600 x
   32 cells, 200 steps, float64) run by fbpic_tpu three times -- direct
   injection, the antenna with the correction off (as the test runs it)
   and on.  fbpic_tpu's antenna deposits J but no rho, so under the
   correction the longitudinal part of its current is projected out.
   Prints the forward and backward peak envelopes (2 Re Er_1 on axis,
   Hilbert envelope), the ratio to the direct pulse against the
   predicted attenuation, and the mode-1 Ez next to the antenna.
2. The port's space-charge initialization of the PWFA drive bunch of
   chip_smoke.py phase 15 (50 pC, gamma 2000, sigma_r = sigma_z = 2 um,
   1,000,000 macroparticles, symmetrized) alone on bench.py's grid, on
   the CPU in float32: the mode-0 Er and Bt against the high-gamma
   Gaussian field of tests/test_space_charge.py, as a fraction of the
   peak.  (Phase 15 loads the plasma first, which draws from the same
   random stream, so its bunch -- and its figure -- differ.)

About 30 s and 2 GB.
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def antenna_current_correction():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from scipy.signal import hilbert
    from fbpic_tpu import Simulation
    from fbpic_tpu.constants import c
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse, GaussianLaser
    Nz, Nr, Nm, zmax, rmax = 600, 32, 2, 30.e-6, 25.e-6
    dt = zmax / Nz / c
    tau, lambda0, z_antenna = 8.e-15, 0.8e-6, 12.e-6
    profile = GaussianLaser(a0=0.01, waist=6.e-6, tau=tau,
                            z0=z_antenna - 3 * c * tau, zf=z_antenna,
                            lambda0=lambda0)
    out = {}
    for method, correct in (("direct", False), ("antenna", False),
                            ("antenna", True)):
        t0 = time.perf_counter()
        sim = Simulation(Nz, zmax, Nr, rmax, Nm, dt, n_order=16,
                         boundaries={"z": "open", "r": "reflective"},
                         random_seed=0, verbose_level=0)
        add_laser_pulse(sim, profile, method=method,
                        z0_antenna=z_antenna if method == "antenna"
                        else None)
        sim.step(200, correct_currents=correct, show_progress=False)
        z = sim.grid_z()
        env = np.abs(hilbert(2 * sim.get_interp_field("Er", 1)[:, 0].real))
        Ez1 = np.abs(sim.get_interp_field("Ez", 1))
        fwd, bwd = z > z_antenna + 2.e-6, z < z_antenna - 2.e-6
        out[(method, correct)] = dict(
            peak_fwd=env[fwd].max(), peak_bwd=env[bwd].max(),
            Ez1_near_antenna=Ez1[np.abs(z - z_antenna) < 1.e-6].max())
        print(f"{method}, correct_currents={correct}: "
              f"{time.perf_counter() - t0:.1f} s, {out[(method, correct)]}",
              flush=True)
    k0dz2 = np.pi / lambda0 * zmax / Nz
    att = (np.sin(k0dz2) / k0dz2) ** 2 * (1 - np.sin(k0dz2) ** 2)
    direct = out[("direct", False)]["peak_fwd"]
    for (method, correct), v in out.items():
        print(f"{method}, correct_currents={correct}: forward peak / "
              f"direct {v['peak_fwd'] / direct:.5f} (predicted "
              f"attenuation {att:.5f}), backward / forward "
              f"{v['peak_bwd'] / v['peak_fwd']:.7f}", flush=True)


def pwfa_space_charge():
    import torch
    import chip_smoke as cs
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_gaussian
    torch.set_num_threads(4)
    sim = Simulation(cs.NZ, cs.ZMAX, cs.NR, cs.RMAX, cs.NM,
                     (cs.ZMAX - cs.ZMIN) / cs.NZ / c, zmin=cs.ZMIN,
                     n_order=32, boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device="cpu",
                     dtype=torch.float32)
    add_particle_bunch_gaussian(sim, q=-e, m=m_e,
                                n_physical_particles=cs.PWFA_Q / e,
                                initialize_self_field=True, **cs.PWFA_BUNCH)
    try:
        cs.pwfa_space_charge_check(sim)
    except RuntimeError as err:
        print(err)


if __name__ == "__main__":
    antenna_current_correction()
    pwfa_space_charge()

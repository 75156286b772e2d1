"""The port against fbpic_tpu's golden laser-wakefield profiles (float64).

tests/test_golden_wake.py pins a small production configuration (open
z, moving window, continuous injection, a0 = 1 laser) against profiles
recorded from fbpic_tpu in float64 (tests/data/golden_wake.npz).  The
port runs the same configuration in float64 with the resident column
layout forced (sort_K; fbpic_tpu recorded the golden with its scatter
path, equal in exact arithmetic) and fbpic_tpu's injection angles, and
must match the 100-step profiles (pin_*) at the golden's own 2e-3 of
each profile's scale.  (The 450-step full_* profiles are not run here:
at ~0.25 s per CPU step they would take this file past its time budget.)
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_wake.npz")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_port_matches_golden_wake_pin():
    from test_torch_step import jax_column_angles
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    Nz, Nr, Nm = 400, 24, 2
    zmax, zmin, rmax = 30.e-6, -10.e-6, 20.e-6
    dt = (zmax - zmin) / Nz / c
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, dt,
                     p_zmin=24.e-6, p_zmax=500.e-6, p_rmin=0.,
                     p_rmax=14.e-6, p_nz=1, p_nr=1, p_nt=4, n_e=4.e24,
                     zmin=zmin, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device="cpu",
                     dtype=torch.float64, sort_K=256)
    assert sim.species_configs[0].resident
    sim.column_angles = jax_column_angles(sim.device_seed, torch.float64)
    add_laser_pulse(sim, GaussianLaser(a0=1.0, waist=8.e-6, tau=10.e-15,
                                       z0=20.e-6))
    sim.set_moving_window(v=c)
    sim.step(100)
    prof = dict(
        Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
        Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
        Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5],
        rho_axis=sim.get_interp_field("rho", 0).real[:, 0])
    gold = np.load(GOLDEN)
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    for name, arr in prof.items():
        g = gold[f"pin_{name}"]
        assert np.isfinite(arr).all(), name
        err = np.abs(arr - g).max() / np.abs(g).max()
        print(f"golden pin {name}: {err:.2e}")
        assert err < 2e-3, (name, err)

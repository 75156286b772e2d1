"""The port against fbpic_tpu's golden laser-wakefield profiles (float64).

tests/test_golden_wake.py pins a small production configuration (open
z, moving window, continuous injection, a0 = 1 laser) against profiles
recorded from fbpic_tpu in float64 (tests/data/golden_wake.npz).  The
port runs the same configuration in float64 with the resident column
layout forced (use_fused_deposit and sort_K; fbpic_tpu recorded the
golden with its scatter path, equal in exact arithmetic) and
fbpic_tpu's injection angles, and must match the 100-step profiles
(pin_*) at the golden's own 2e-3 of
each profile's scale.  (The 450-step full_* profiles are not run here:
at ~0.25 s per CPU step they would take this file past its time budget;
chip_smoke.py and tests/test_torch_cuda.py run them on the card, with
fbpic_tpu's angles from tests/data/torch_golden_angles.npz, which the
last test here checks against fbpic_tpu's draws.)
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_wake.npz")
#: fbpic_tpu's injection angles of the 450-step golden run, recorded by
#: tools/torch_golden_angles.py for the card (which has no JAX)
ANGLES = os.path.join(os.path.dirname(__file__), "data",
                      "torch_golden_angles.npz")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def golden_config_sim():
    """tests/test_golden_wake.py's configuration through the port,
    float64 on the CPU, the resident layout forced."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    Nz, Nr, Nm = 400, 24, 2
    zmax, zmin, rmax = 30.e-6, -10.e-6, 20.e-6
    dt = (zmax - zmin) / Nz / c
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, dt, zmin=zmin, n_order=32,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device="cpu",
                     dtype=torch.float64)
    sim.use_fused_deposit = True         # force the resident layout
    sim.add_new_species(q=-e, m=m_e, n=4.e24, p_zmin=24.e-6,
                        p_zmax=500.e-6, p_rmin=0., p_rmax=14.e-6, p_nz=1,
                        p_nr=1, p_nt=4, sort_K=256)
    assert sim.species_configs[0].resident
    add_laser_pulse(sim, GaussianLaser(a0=1.0, waist=8.e-6, tau=10.e-15,
                                       z0=20.e-6))
    sim.set_moving_window(v=c)
    return sim


def profiles(sim):
    """tests/test_golden_wake.py's four profiles."""
    return dict(
        Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
        Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
        Er1_r5=np.abs(sim.get_interp_field("Er", 1))[:, 5],
        rho_axis=sim.get_interp_field("rho", 0).real[:, 0])


def test_port_matches_golden_wake_pin():
    from test_torch_step import jax_column_angles
    sim = golden_config_sim()
    sim.column_angles = jax_column_angles(sim.device_seed, torch.float64)
    sim.step(100)
    prof = profiles(sim)
    gold = np.load(GOLDEN)
    assert sim.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    for name, arr in prof.items():
        g = gold[f"pin_{name}"]
        assert np.isfinite(arr).all(), name
        err = np.abs(arr - g).max() / np.abs(g).max()
        print(f"golden pin {name}: {err:.2e}")
        assert err < 2e-3, (name, err)


def test_recorded_golden_angles_are_fbpic_tpus():
    """tests/data/torch_golden_angles.npz holds fbpic_tpu's own draws:
    the seed the golden configuration derives, and for every recorded
    injection (its iteration, species and column keys) the angles
    jax.random gives, bit for bit; the injections span the 450 steps."""
    from test_torch_step import jax_column_angles
    d = np.load(ANGLES)
    seed = int(d["seed"])
    assert seed == golden_config_sim().device_seed
    angles = jax_column_angles(seed, torch.float64)
    its = d["iteration"]
    assert len(its) == len(set(its.tolist())) and its.max() < 450 <= \
        its.max() + 2 * np.diff(its).max()
    for it, sp, keys, phi in zip(its, d["species"], d["nkey"], d["angles"]):
        np.testing.assert_array_equal(
            angles(int(it), int(sp), torch.as_tensor(keys)).numpy(), phi)

"""fbpic_tpu's float64 default path (no sort_K: the scatter deposits and
the linear gather of non-resident species) on the two configurations of
tests/test_moving_window.py, for the same number of steps, in both
packages (the port fed fbpic_tpu's injection angles).

- The laser in vacuum of test_window_follows_laser (no species, 240
  steps): every field to 1e-8 of the scale of its vector, and that
  test's own checks on the port (centroid, window position).
- The plasma of test_continuous_injection_uniform_density (100 steps,
  injection into the ring at its cursor): every particle slot by slot
  (positions and weights to 1e-12 of their vector's scale, which slots
  are live exactly), the ring cursor and the injection front exactly,
  rho to 1e-8 of its scale, and that test's density checks on the port.
  A cold plasma at rest with no laser has no fields of its own: E, B,
  J and the momenta are float64 roundoff noise, summed in another order
  by each package, and are held to physical scales instead (fields to
  1e-8, momenta to 1e-12: tests/test_torch_ring.py::noise_scales).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c, e  # noqa: E402


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _pair(Nz, zmax, Nr, rmax, Nm, dt, **kw):
    from test_torch_step import jax_column_angles
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    s0 = S0(Nz, zmax, Nr, rmax, Nm, dt, **kw)
    s1 = S1(Nz, zmax, Nr, rmax, Nm, dt, device="cpu", dtype=torch.float64,
            **kw)
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    assert not s1.use_fused_deposit
    return s0, s1


def test_window_follows_laser_like_fbpic_tpu():
    from test_torch_ring import compare_states
    from test_torch_step import jax_state_to_numpy
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    Nz, Nr, Nm = 160, 24, 2
    zmax, rmax = 16.e-6, 20.e-6
    s0, s1 = _pair(Nz, zmax, Nr, rmax, Nm, zmax / Nz / c, n_order=16,
                   boundaries={"z": "open", "r": "reflective"},
                   random_seed=0)
    z0 = 8.e-6
    laser = dict(a0=0.01, waist=6.e-6, tau=8.e-15, z0=z0, lambda0=0.8e-6)
    a0(s0, L0(**laser))
    a1(s1, L1(**laser))
    s0.set_moving_window(v=c)
    s1.set_moving_window(v=c)
    s0.step(240, show_progress=False)
    s1.step(240)
    compare_states(jax_state_to_numpy(s0.state), s1.state)
    # tests/test_moving_window.py::test_window_follows_laser on the port
    z = s1.grid_z()
    env = np.abs(s1.get_interp_field("Er", 1)[:, 0])
    centroid = np.sum(z * env**2) / np.sum(env**2)
    assert env.max() > 0.3 * 4e10
    assert abs(centroid - (z0 + c * s1.time)) < 3 * zmax / Nz
    assert abs(s1.zmin - (-s1.nd_edge * s1.config.dz + c * s1.time)) \
        < 2 * s1.config.dz


def test_continuous_injection_uniform_density_like_fbpic_tpu():
    from test_torch_ring import compare_states, noise_scales
    from test_torch_step import jax_state_to_numpy
    Nz, Nr, Nm = 120, 16, 2
    zmax, rmax = 12.e-6, 12.e-6
    dt = zmax / Nz / c
    n_e, n_steps = 1.e24, 100
    s0, s1 = _pair(Nz, zmax, Nr, rmax, Nm, dt, p_zmin=0., p_zmax=zmax,
                   p_rmin=0., p_rmax=0.75 * rmax, p_nz=2, p_nr=2, p_nt=4,
                   n_e=n_e, n_order=16,
                   boundaries={"z": "open", "r": "reflective"},
                   random_seed=0)
    sc = s1.species_configs[0]
    assert sc.sort_K == 0 and not sc.resident
    assert s0.species_configs[0].sort_K == 0
    s0.set_moving_window(v=c)
    s1.set_moving_window(v=c)
    s0.step(n_steps, correct_currents=True, show_progress=False)
    s1.step(n_steps, correct_currents=True)
    ref = jax_state_to_numpy(s0.state)
    compare_states(ref, s1.state,
                   scales=noise_scales(s1, ref, n_steps, n_e))
    assert s1.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    # tests/test_moving_window.py::test_continuous_injection_uniform_density
    rho = s1.get_interp_field("rho", 0).real
    inner = rho[10:-10, :8]
    assert np.allclose(inner, -e * n_e, rtol=0.1)
    assert np.std(inner) < 0.05 * abs(e * n_e)

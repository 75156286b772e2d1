"""The published boosted-frame script as written
(examples/boosted_frame_script.py:38-58 at its smoke size, :34-35:
gamma_boost = 10, Galilean v_comoving = -c beta_boost, a0 = 2 laser,
open z, moving window, continuous injection, no diagnostics) from its
empty box (p_zmin = 0 lab): fbpic_tpu_torch against fbpic_tpu in
float64 (both packages' default there: sort_K = 0, the species a ring,
the linear gather and the scatter deposits), the port fed fbpic_tpu's
injection angles.  random_seed = 0 is the only addition.

The plasma enters from the injection plane at the first exchange and
streams in at about 2c relative to the window; after 80 steps every
particle slot agrees to 1e-12 of its vector's scale and every field to
1e-8 (tests/test_torch_boosted.py's gates).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

GAMMA = 10.
N_STEPS = 80


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _script(Simulation, add_laser_pulse, GaussianLaser, **dev):
    """examples/boosted_frame_script.py:38-56 at the smoke size."""
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter
    boost = BoostConverter(GAMMA)
    Nz, zmax_lab, zmin_lab = 256, 0.e-6, -40.e-6
    Nr, rmax, Nm, n_order, ppc = 12, 40.e-6, 2, 16, (1, 1, 4)
    zmin, zmax = boost.static_length([zmin_lab, zmax_lab])
    dt = (zmax - zmin) / Nz / c
    n_e, = boost.static_density([1.e24])
    v_window, = boost.velocity([c])
    sim = Simulation(Nz, zmax, Nr, rmax, Nm, dt, zmin=zmin, n_order=n_order,
                     gamma_boost=GAMMA,
                     v_comoving=-c * np.sqrt(1. - 1. / GAMMA**2),
                     use_galilean=True,
                     boundaries={'z': 'open', 'r': 'reflective'},
                     random_seed=0, **dev)
    sim.add_new_species(q=-e, m=m_e, n=n_e, p_zmin=0.,
                        p_zmax=boost.static_length([2000.e-6])[0],
                        p_rmax=35.e-6, p_nz=ppc[0], p_nr=ppc[1],
                        p_nt=ppc[2], continuous_injection=True,
                        boost_positions_in_dens_func=True)
    add_laser_pulse(sim, GaussianLaser(a0=2., waist=10.e-6, tau=30.e-15,
                                       z0=-15.e-6), gamma_boost=GAMMA)
    sim.set_moving_window(v=v_window)
    return sim


def test_published_boosted_script_from_empty_box_like_fbpic_tpu():
    from test_torch_ring import compare_states
    from test_torch_step import jax_column_angles, jax_state_to_numpy
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    s0 = _script(S0, a0, L0, verbose_level=0)
    s1 = _script(S1, a1, L1, device="cpu", dtype=torch.float64)
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    for s in (s0, s1):
        sc = s.species_configs[0]
        assert sc.sort_K == 0 and not sc.resident
        assert int((np.asarray(s.state.species[0].w) != 0).sum()) == 0
    s0.step(N_STEPS, show_progress=False)
    s1.step(N_STEPS)
    ref = jax_state_to_numpy(s0.state)
    assert (ref["species"][0]["w"] != 0).sum() > 0     # plasma entered
    compare_states(ref, s1.state)
    assert s1.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}

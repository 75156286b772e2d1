"""fbpic_tpu's float64 default path (no sort_K: scatter deposits, linear
gather, injection into the ring at its cursor) on the configuration of
tests/test_continuous_injection_seam.py (fused=False), in both packages
(the port fed fbpic_tpu's injection angles).

fbpic_tpu runs 290 of that test's 400 steps; the port runs steps
220-290 from fbpic_tpu's state at step 220, carried by
``utils.carry.state_from_numpy``: on the way the ring cursor wraps past
the end of the ring onto the slots the removal freed, and at the end
everything in the box is injected plasma, as in that test's end state
(the window has moved 1.45 box lengths).  The port's first steps (initial
plasma, first injections) are held in tests/test_torch_ring_window.py
and tests/test_torch_ring.py.  (The port's CPU step takes ~0.6 s here:
all 400 steps would take the file far past its time budget.)

Gates as in tests/test_torch_ring_window.py: particles slot by slot
(positions and weights to 1e-12 of their vector's scale, which slots
are live exactly), the cursor, the injection front, grid edge and time
exactly, rho to 1e-8 of its scale; the fields, currents and momenta of
this cold undriven plasma are roundoff noise, held to 1e-8 (fields) and
1e-12 (momenta) of physical scales.  The port's end state must also pass
that test's seam checks, against the density profile the port deposits
after one step from the same initial state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c  # noqa: E402

NZ, NR, NM = 200, 40, 2
ZMAX, ZMIN, RMAX = 10.e-6, 0.e-6, 30.e-6
DT = (ZMAX - ZMIN) / NZ / c
N_E = 8.e24
KW = dict(p_zmin=2.e-6, p_zmax=500.e-6, p_rmin=0., p_rmax=27.e-6, p_nz=2,
          p_nr=2, p_nt=4, n_e=N_E, zmin=ZMIN, n_order=16,
          boundaries={"z": "open", "r": "reflective"}, random_seed=0,
          verbose_level=0)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def seam_sims(fused=False):
    """fbpic_tpu and the port on the seam configuration (fused: sort_K =
    768 set after the species, as that test does, and the fused deposit
    on in both), the port fed fbpic_tpu's injection angles."""
    import dataclasses
    from test_torch_step import jax_column_angles
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    s0 = S0(NZ, ZMAX, NR, RMAX, NM, DT, **KW)
    s1 = S1(NZ, ZMAX, NR, RMAX, NM, DT, device="cpu", dtype=torch.float64,
            **KW)
    for s in (s0, s1):
        if fused:
            s.species_configs[0] = dataclasses.replace(
                s.species_configs[0], sort_K=768)
        s.use_fused_deposit = fused
        s.set_moving_window(v=c)
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    assert s0.state.species[0].capacity == s1.state.species[0].capacity
    return s0, s1


def seam_checks(sim, rho0):
    """tests/test_continuous_injection_seam.py's checks."""
    rho1 = np.asarray(sim.get_interp_field("rho", 0).real)
    mid = slice(60, 140)
    p0, p1 = rho0[mid].mean(axis=0), rho1[mid].mean(axis=0)
    ref = p0[10]
    assert np.abs(p1 / ref - p0 / ref)[:30].max() < 1e-3
    col = rho1[mid, 5]
    assert np.std(col) / np.abs(np.mean(col)) < 1e-3


def test_seam_scatter_path_like_fbpic_tpu():
    from test_torch_ring import compare_states, noise_scales
    from test_torch_step import jax_state_to_numpy
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    s0, s1 = seam_sims()
    assert s1.species_configs[0].sort_K == 0
    assert not s1.species_configs[0].resident
    # the test's first step() call, for its reference density profile
    s0.step(1, show_progress=False)
    s1.step(1)
    rho0 = np.asarray(s1.get_interp_field("rho", 0).real)
    # steps 220-290 from fbpic_tpu's state at 220
    s0.step(219, show_progress=False)
    at220 = jax_state_to_numpy(s0.state)
    s0.step(70, show_progress=False)
    ref = jax_state_to_numpy(s0.state)
    s1.state = state_from_numpy(**at220, device="cpu")
    s1.step(70)
    compare_states(ref, s1.state, scales=noise_scales(s1, ref, 70, N_E))
    # the ring cursor wrapped past the end of the ring on the way
    assert ref["species"][0]["next_free"] < at220["species"][0]["next_free"]
    assert s1.overflow_totals["ring_overwrite"] == 0
    seam_checks(s1, rho0)

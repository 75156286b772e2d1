"""Cross-deposition: fbpic_tpu_torch against fbpic_tpu (float64).

- Both cross corrections (``correct_currents_crossdeposition_standard``
  and ``_comoving``, the latter with Galilean coefficients) on
  numpy-seeded complex fields, with each package's own coefficients of
  the same grid: 1e-12 of each output's largest value.
- ``_cross_deposit`` (the charge at the mixed positions z[n], x[n+1] and
  z[n+1], x[n], with the Galilean grid drift between them) on the same
  particles: 1e-12.
- Short runs through both packages' Simulation, every state array held
  at tests/test_torch_step.py's tolerances (particles 1e-12, fields 1e-8
  of the largest value of their vector; the cross fields too):
  - the standard scheme on tests/test_torch_ring.py's window
    configuration (open z, moving window, continuous injection, a laser)
    with the species sized resident (use_fused_deposit, sort_K): under
    cross-deposition it runs non-resident on the legacy sorted plan,
    with the exchange block every step;
  - the Galilean scheme on a drifting periodic plasma (scatter
    deposits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

NM = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Cap torch's CPU threads (the suite runs several test processes
    side by side) for the whole module: pytest sets the shared runs up
    before any function-scoped fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _auxes(scheme):
    from fbpic_tpu.fields.solver import GridConfig, build_field_aux as b0
    from fbpic_tpu_torch.fields.solver import build_field_aux as b1
    from fbpic_tpu_torch.utils.carry import config_from
    kw = dict(Nz=12, Nr=10, Nm=NM, dz=0.1e-6, dr=0.2e-6, rmax=2.e-6,
              dt=0.1e-6 / c, n_order=8,
              current_correction="cross-deposition")
    if scheme == "galilean":
        kw.update(v_comoving=-0.9 * c, use_galilean=True)
    cfg = GridConfig(**kw)
    return b0(cfg), b1(config_from(cfg), device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("scheme", ["standard", "galilean"])
def test_cross_corrections_match(scheme):
    from fbpic_tpu.fields import psatd_push as p0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.fields import psatd_push as p1
    aux0, aux1 = _auxes(scheme)
    rng = np.random.RandomState(4)
    shape = (NM, 12, 10)
    arrs = [rng.randn(*shape) + 1j * rng.randn(*shape) for _ in range(7)]
    j = [CArr.from_numpy(a, jnp.float64) for a in arrs]
    t = [torch.as_tensor(a) for a in arrs]
    inv_dt = 1.0 / (0.1e-6 / c)
    if scheme == "standard":
        out0 = p0.correct_currents_crossdeposition_standard(
            *j, aux0.kz, aux0.kr, inv_dt)
        out1 = p1.correct_currents_crossdeposition_standard(
            *t, aux1.kz, aux1.kr, inv_dt)
    else:
        out0 = p0.correct_currents_crossdeposition_comoving(
            *j, aux0.kz, aux0.kr, aux0.j_corr_coef, aux0.T_eb, aux0.T_cc,
            inv_dt)
        out1 = p1.correct_currents_crossdeposition_comoving(
            *t, aux1.kz, aux1.kr, aux1.j_corr_coef, aux1.T_eb, aux1.T_cc,
            inv_dt)
    for a, b in zip(out0, out1):
        ref = a.to_numpy()
        assert np.abs(b.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    # correct_divE rides on the same operands (kz, kr, 1/k^2)
    d0 = p0.correct_divE(j[0], j[1], j[2], j[3], aux0.kz, aux0.kr,
                         aux0.inv_k2)
    d1 = p1.correct_divE(t[0], t[1], t[2], t[3], aux1.kz, aux1.kr,
                         aux1.inv_k2)
    for a, b in zip(d0, d1):
        ref = a.to_numpy()
        assert np.abs(b.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _drift_sims(**extra):
    """A drifting, density-modulated periodic plasma (tests/
    test_torch_step.py's periodic run) in both packages."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    Nz, Nr = 48, 16
    Lz, rmax = 20.e-6, 15.e-6
    kw = dict(zmin=0., boundaries={"z": "periodic", "r": "reflective"},
              current_correction="cross-deposition", random_seed=0,
              verbose_level=0, **extra)
    sp = dict(q=-e, m=m_e, n=1.e24, p_nz=2, p_nr=2, p_nt=4, uz_m=0.05,
              p_zmin=0., p_zmax=Lz, p_rmax=12.e-6,
              dens_func=lambda z, r: 1. + 0.05 * np.sin(2 * np.pi * z / Lz))
    s0 = S0(Nz, Lz, Nr, rmax, NM, Lz / Nz / c, **kw)
    s1 = S1(Nz, Lz, Nr, rmax, NM, Lz / Nz / c, device="cpu",
            dtype=torch.float64, **kw)
    s0.add_new_species(**sp)
    s1.add_new_species(**sp)
    return s0, s1


@pytest.fixture(scope="module")
def galilean_drift():
    """The Galilean drifting pair of the deposit test and the 8-step run,
    built once: fbpic_tpu advanced 3 steps (its state then kept as a
    copy, for the deposit test: the next step() call donates it), then
    on to 8 in a second step() call."""
    s0, s1 = _drift_sims(v_comoving=0.04 * c, use_galilean=True)
    s0.step(3, show_progress=False)
    state3 = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                    s0.state)
    s0.step(5, show_progress=False)
    return s0, s1, state3


def test_cross_deposit_matches(galilean_drift):
    """_cross_deposit on a drifting plasma, the Galilean drift vg*dt
    between its two deposits."""
    from fbpic_tpu.core.step import _cross_deposit as x0, \
        StepOptions as O0
    from fbpic_tpu_torch.core.step import _cross_deposit as x1
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    from test_torch_pml import jax_fields
    s0, s1, st0 = galilean_drift
    vg_dt = 0.04 * c * s0.dt
    spect0 = x0(s0.config, O0(), s0.aux, st0.spect, list(st0.species),
                tuple(s0.species_configs), st0.zmin, vg_dt=vg_dt)
    spect, interp = jax_fields(st0)
    sp = st0.species[0]
    species = [{n: np.asarray(getattr(sp, n)) for n in
                ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")}]
    st1 = state_from_numpy(spect, interp, species, float(st0.time),
                           float(st0.zmin), int(st0.iteration),
                           device="cpu")
    spect1 = x1(s1.config, s1.build_options(), s1.aux, st1.spect,
                st1.species, s1.species_configs, st1.zmin, vg_dt=vg_dt)
    for name in ("rho_next_xy", "rho_next_z"):
        ref = getattr(spect0, name).to_numpy()
        out = getattr(spect1, name).numpy()
        assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max(), name


def _gate(s0, s1):
    from test_torch_pml import compare_fields
    from test_torch_ring import compare_states
    from test_torch_step import jax_state_to_numpy
    compare_states(jax_state_to_numpy(s0.state), s1.state)
    compare_fields(s0.state, s1.state, 1e-8)


def test_cross_standard_window_run_matches():
    from test_torch_step import jax_column_angles
    from test_torch_ring import (NZ_PHYS, ZMAX, NR, RMAX, DT, SIM_KW,
                                 SPECIES_KW, LASER_KW)
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    kw = dict(SIM_KW, current_correction="cross-deposition")
    s0 = S0(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **kw)
    s1 = S1(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
            dtype=torch.float64, **kw)
    for sim, add, L in ((s0, a0, L0), (s1, a1, L1)):
        sim.use_fused_deposit = True
        sim.add_new_species(**SPECIES_KW, sort_K=256)
        add(sim, L(**LASER_KW))
        sim.set_moving_window(v=c)
        # sized resident, run non-resident on the legacy sorted plan
        assert sim.species_configs[0].resident
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    s0.step(6, show_progress=False)
    s1.step(6)
    _gate(s0, s1)


def test_cross_galilean_run_matches(galilean_drift):
    """8 steps in two step() calls, 3 + 5, in both packages (the pair
    shared with the deposit test)."""
    s0, s1, _ = galilean_drift
    s1.step(3)
    s1.step(5)
    _gate(s0, s1)

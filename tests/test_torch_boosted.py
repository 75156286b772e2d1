"""The boosted-frame Galilean / comoving slice: fbpic_tpu_torch against
fbpic_tpu (float64).

- BoostConverter, the boosted species load (lab-frame p_zmin, p_zmax,
  n, uz_m, uz_th and dens_func converted to the boosted frame) and the
  boosted laser fields: host numpy code in both packages, 1e-12
  relative (the loads are bit-equal).
- deposit_rho_J_sorted with a Galilean vz_shift on the resident path's
  inputs: 1e-12 relative in float64, 2e-6 in float32 (the float32 sums
  run in another order).
- 20 steps of examples/boosted_frame_script.py at its smoke size
  (:34-35), with the plasma loaded from the box's left edge (-40 um lab)
  so both packages run the resident layout, for the Galilean and the
  comoving scheme.  fbpic_tpu runs with the resident layout forced and
  the same sort_K, and its injection angles feed the port.  Particles
  agree to 1e-12 of their scale (in the resident storage order), fields
  to 1e-8 of their scale (the curl-free correction amplifies the float64
  roundoff of deposits summed in another order; tests/test_torch_step.py).
  The scale of a vector quantity is that of the whole vector: position,
  momentum, E, B, J, rho.  The laser-driven transverse components (uy,
  Jp) are ~1e-4 of their vector, and the roundoff they pick up from the
  longitudinal part is relative to the vector, not to themselves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

GAMMA = 10.
PARTICLE = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")
INTERP = ("Er", "Et", "Ez", "Br", "Bt", "Bz")
SPECT = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz", "Jp", "Jm", "Jz", "rho_prev",
         "rho_next")
# The vector each array is a component of (its scale in the step gates)
VECTORS = (("x", "y", "z"), ("ux", "uy", "uz"), ("inv_gamma",), ("w",),
           ("Er", "Et", "Ez"), ("Br", "Bt", "Bz"), ("Ep", "Em", "Ez"),
           ("Bp", "Bm", "Bz"), ("Jp", "Jm", "Jz"), ("rho_prev", "rho_next"))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(ref, out, name, tol, scale=None):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    if scale is None:
        scale = np.abs(ref).max()
    if scale == 0:
        assert np.abs(out).max() == 0, name
    else:
        assert np.abs(out - ref).max() <= tol * scale, name


def test_boost_converter_matches_jax():
    from fbpic_tpu.lpa_utils.boosted_frame import BoostConverter as B0
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter as B1
    b0, b1 = B0(GAMMA), B1(GAMMA)
    rng = np.random.RandomState(7)
    vals = list(rng.uniform(-50e-6, 50e-6, 4))
    for name in ("static_length", "static_density", "velocity",
                 "wavenumber"):
        _close(getattr(b0, name)(vals), getattr(b1, name)(vals), name, 1e-12)
    for name in ("copropag_length", "copropag_density"):
        _close(getattr(b0, name)(vals, beta_object=0.3),
               getattr(b1, name)(vals, beta_object=0.3), name, 1e-12)
    us = list(rng.uniform(0.5, 20.0, 4))
    for name in ("longitudinal_momentum", "gamma"):
        _close(getattr(b0, name)([1.0 + u for u in us]),
               getattr(b1, name)([1.0 + u for u in us]), name, 1e-12)
    arrs = [rng.randn(50) * s for s in (1e-5, 1e-5, 1e-5, 1.0, 1.0, 5.0)]
    arrs.append(1 / np.sqrt(1 + arrs[3]**2 + arrs[4]**2 + arrs[5]**2))
    for a, b in zip(b0.boost_particle_arrays(*arrs),
                    b1.boost_particle_arrays(*arrs)):
        _close(a, b, "boost_particle_arrays", 1e-12)
    _close(b0.interaction_time(1e-3, 40e-6, c),
           b1.interaction_time(1e-3, 40e-6, c), "interaction_time", 1e-12)


def _boosted_grid():
    """examples/boosted_frame_script.py:17-45 at the smoke size (:34)."""
    from fbpic_tpu.lpa_utils.boosted_frame import BoostConverter
    boost = BoostConverter(GAMMA)
    Nz, Nr, Nm = 256, 12, 2
    zmin, zmax = boost.static_length([-40.e-6, 0.e-6])
    n_e, = boost.static_density([1.e24])
    v_window, = boost.velocity([c])
    return boost, dict(Nz=Nz, zmax=zmax, Nr=Nr, rmax=40.e-6, Nm=Nm,
                       dt=(zmax - zmin) / Nz / c, zmin=zmin, n_e=n_e,
                       v_window=v_window)


def _sim_kw(g, scheme, **extra):
    v = -c * np.sqrt(1. - 1. / GAMMA**2)
    return dict(zmin=g["zmin"], n_order=16, gamma_boost=GAMMA,
                v_comoving=v, use_galilean=(scheme == "galilean"),
                boundaries={"z": "open", "r": "reflective"},
                random_seed=0, verbose_level=0, **extra)


def test_boosted_species_load_and_laser_match_jax():
    """A drifting, thermal beam with a density function whose z is
    boosted, and the lab-frame plasma of the example; then the a0 = 2
    laser of the example added with gamma_boost."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    boost, g = _boosted_grid()
    grid = (g["Nz"], g["zmax"], g["Nr"], g["rmax"], g["Nm"], g["dt"])
    s0 = S0(*grid, **_sim_kw(g, "galilean"))
    s1 = S1(*grid, **_sim_kw(g, "galilean"), device="cpu",
            dtype=torch.float64)
    assert s0.config.Nz == s1.config.Nz
    assert s0.config.n_guard == s1.config.n_guard
    assert s0.exchange_period == s1.exchange_period
    species = [
        dict(q=-e, m=m_e, n=1.e24, p_zmin=-40.e-6, p_zmax=2000.e-6,
             p_rmax=35.e-6, p_nz=1, p_nr=1, p_nt=4,
             boost_positions_in_dens_func=True),
        dict(q=-e, m=m_e, n=2.e23, p_zmin=-0.2e-6, p_zmax=-0.05e-6,
             p_rmax=5.e-6, p_nz=2, p_nr=2, p_nt=4, uz_m=50., uz_th=0.5,
             ux_th=0.1, dens_func=lambda z, r: 1. + 0.5 * np.cos(1e7 * z),
             boost_positions_in_dens_func=True, sort_K=128),
    ]
    for i, kw in enumerate(species):
        s0.add_new_species(**kw)
        s1.add_new_species(**kw)
        sp0, sp1 = s0.state.species[i], s1.state.species[i]
        n = int((np.asarray(sp0.w) != 0).sum())
        assert n > 0 and n == s1.ptcl[i].Ntot
        for name in PARTICLE:
            _close(np.asarray(getattr(sp0, name))[:n],
                   getattr(sp1, name).numpy()[:n], name, 1e-12)
        ic0, ic1 = s0._injector_configs[i], s1._injector_configs[i]
        for name in ("dz_particles", "n", "uz_m", "uz_th", "v_end_plasma"):
            assert getattr(ic0, name) == getattr(ic1, name), name
    a0(s0, L0(a0=2., waist=10.e-6, tau=30.e-15, z0=-15.e-6),
       gamma_boost=GAMMA)
    a1(s1, L1(a0=2., waist=10.e-6, tau=30.e-15, z0=-15.e-6),
       gamma_boost=GAMMA)
    for name in INTERP:
        _close(s0.get_interp_field(name), s1.get_interp_field(name), name,
               1e-12)
    s0.set_moving_window(v=c, gamma_boost=GAMMA)
    s1.set_moving_window(v=c, gamma_boost=GAMMA)
    assert s0.moving_win == s1.moving_win == g["v_window"]


@pytest.mark.parametrize("dtype,tol,with_drho", [
    (np.float64, 1e-12, False), (np.float32, 2e-6, False),
    (np.float32, 2e-6, True)])
def test_deposit_with_vz_shift_matches_jax(dtype, tol, with_drho,
                                           monkeypatch):
    """The resident path's deposit with the sort half a push behind and
    a Galilean grid drift of -0.995 c (rho / d(rho) endpoints move
    relative to the flowing grid)."""
    from test_torch_kernels import _deposit_inputs, _jax_sort, _port_sort
    from fbpic_tpu.particles import sorted_deposit as s0
    from fbpic_tpu_torch.particles import sorted_deposit as s1
    monkeypatch.setenv("FBPIC_TPU_PALLAS_DEPOSIT", "0")
    arrs, g = _deposit_inputs(dtype=dtype)
    js, ts = _jax_sort(arrs, g), _port_sort(arrs, g)
    vz_shift = -c * np.sqrt(1. - 1. / GAMMA**2)
    dt_half = dtype(0.25 * g["dz"] / c)
    kw = dict(zfold="clamp", with_drho=with_drho, with_rho=not with_drho,
              sort_at_start=True, vz_shift=vz_shift)
    geo = (g["Nm"], 1 / g["dz"], g["zmin"], g["Nz"], 1 / g["dr"], 0.0,
           g["Nr"])
    x0, tp = js["padded"], ts["padded"]
    ref = s0.deposit_rho_J_sorted(
        js, *x0[:4], dtype(-1.6e-19), *x0[4:8], dt_half, *geo,
        tuple(jnp.asarray(t) for t in g["ruy"]), **kw)
    out = s1.deposit_rho_J_sorted(
        ts, *tp[:4], dtype(-1.6e-19), *tp[4:8], dt_half, *geo,
        torch.as_tensor(g["ruy"]), **kw)
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a.to_numpy(), b.numpy(), "deposit", tol)
    # the shift moves the rho / d(rho) deposit
    kw0 = dict(kw, vz_shift=0.0)
    moved = s1.deposit_rho_J_sorted(
        ts, *tp[:4], dtype(-1.6e-19), *tp[4:8], dt_half, *geo,
        torch.as_tensor(g["ruy"]), **kw0)
    assert float((moved[-1] - out[-1]).abs().max()) > \
        1e-3 * float(out[-1].abs().max())


def jax_state_arrays(state):
    sp = state.species[0]
    return dict(
        particles={n: np.asarray(getattr(sp, n)) for n in PARTICLE},
        interp={n: getattr(state.interp, n).to_numpy() for n in INTERP},
        spect={n: getattr(state.spect, n).to_numpy() for n in SPECT},
        zmin=float(state.zmin), time=float(state.time),
        inj_z_end=float(sp.inj_z_end))


def boosted_smoke_sims(scheme, n_steps=20):
    """Both packages' Simulation of the smoke-size boosted example, the
    port fed fbpic_tpu's injection angles; fbpic_tpu advanced n_steps
    (None: one exchange period, so that its next step is an exchange
    step)."""
    from test_torch_step import jax_column_angles
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    boost, g = _boosted_grid()
    grid = (g["Nz"], g["zmax"], g["Nr"], g["rmax"], g["Nm"], g["dt"])
    species = dict(q=-e, m=m_e, n=g["n_e"], p_zmin=-40.e-6,
                   p_zmax=boost.static_length([2000.e-6])[0],
                   p_rmax=35.e-6, p_nz=1, p_nr=1, p_nt=4,
                   continuous_injection=True,
                   boost_positions_in_dens_func=True, sort_K=128)
    laser = dict(a0=2., waist=10.e-6, tau=30.e-15, z0=-15.e-6)
    s0 = S0(*grid, **_sim_kw(g, scheme))
    s0.use_fused_deposit = True          # force the resident layout
    s0.add_new_species(**species)
    a0(s0, L0(**laser), gamma_boost=GAMMA)
    s0.set_moving_window(v=g["v_window"])
    s1 = S1(*grid, **_sim_kw(g, scheme), device="cpu", dtype=torch.float64)
    s1.use_fused_deposit = True          # force the resident layout
    s1.add_new_species(**species)
    a1(s1, L1(**laser), gamma_boost=GAMMA)
    s1.set_moving_window(v=g["v_window"])
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    sc0, sc1 = s0.species_configs[0], s1.species_configs[0]
    assert sc0.resident and sc1.resident
    assert sc0.resort == sc1.resort == "banded"
    assert s0.exchange_period == s1.exchange_period
    s0.step(n_steps or s0.exchange_period, show_progress=False)
    return s0, s1


def test_carried_galilean_state_steps_like_jax():
    """An fbpic_tpu Galilean state carried into the port
    (``utils.carry``: the grid config field by field, comoving fields
    included, and the state's arrays), the port's coefficients rebuilt
    from the carried config; then one exchange step (removal, injection
    of drifting columns, fresh rho_prev) and one banded step from the
    same state in both packages, gated as in tests/test_torch_step.py
    (particles 1e-12, fields 1e-8 of scale)."""
    from fbpic_tpu.core.step import make_step_fn as m0
    from fbpic_tpu_torch.core.step import make_step_fn as m1
    from fbpic_tpu_torch.fields import build_field_aux
    from fbpic_tpu_torch.utils.carry import config_from, state_from_numpy
    from test_torch_step import jax_column_angles, jax_state_to_numpy
    s0, s1 = boosted_smoke_sims("galilean", n_steps=None)
    config = config_from(s0.config)
    assert config == s1.config and config.use_comoving
    aux = build_field_aux(config, s1.smoother, device="cpu",
                          dtype=torch.float64)
    step0 = jax.jit(m0(s0.config, tuple(s0.species_configs),
                       s0.build_options()))
    step1 = m1(config, s1.species_configs, s1.build_options())
    angles = jax_column_angles(int(s0.state.seed), torch.float64)
    state0 = s0.state
    for _ in range(2):          # exchange step, then a banded re-sort step
        state1 = state_from_numpy(**jax_state_to_numpy(state0),
                                  device="cpu")
        state0 = step0(state0, s0.aux, tuple(s0._injector_auxes), (), (),
                       ())
        state1 = step1(state1, aux, tuple(s1._injector_auxes), angles,
                       s1.generator)
        ref = jax_state_to_numpy(state0)
        for n in ("time", "zmin", "mw_zref"):
            assert float(getattr(state1, n)) == ref[n], n
        sp_ref, sp = ref["species"][0], state1.species[0]
        assert sp.next_free == sp_ref["next_free"]
        np.testing.assert_array_equal(sp_ref["w"] != 0, sp.w.numpy() != 0)
        for kind, names, obj, tol in (
                ("species", PARTICLE, sp, 1e-12),
                ("interp", INTERP, state1.interp, 1e-8),
                ("spect", SPECT, state1.spect, 1e-8)):
            arrays = sp_ref if kind == "species" else ref[kind]
            for vec in VECTORS:
                if not set(vec) <= set(names):
                    continue
                scale = max(np.abs(arrays[n]).max() for n in vec)
                for n in vec:
                    _close(arrays[n], getattr(obj, n).numpy(), n, tol,
                           scale=scale)


@pytest.mark.parametrize("scheme", ["galilean", "comoving"])
def test_boosted_smoke_steps_match_jax(scheme):
    s0, s1 = boosted_smoke_sims(scheme)
    s1.step(20)
    ref = jax_state_arrays(s0.state)
    assert s1.overflow_totals == {"sort_overflow": 0, "ring_overwrite": 0}
    assert int(s0.state.sort_overflow) == 0
    assert s1.iteration == 20
    assert float(s1.state.zmin) == ref["zmin"]
    assert float(s1.state.time) == ref["time"]
    sp = s1.state.species[0]
    assert float(sp.inj_z_end) == ref["inj_z_end"]
    np.testing.assert_array_equal(ref["particles"]["w"] != 0,
                                  sp.w.numpy() != 0)
    for kind, names, obj, tol in (
            ("particles", PARTICLE, sp, 1e-12),
            ("interp", INTERP, s1.state.interp, 1e-8),
            ("spect", SPECT, s1.state.spect, 1e-8)):
        for vec in VECTORS:
            if not set(vec) <= set(names):
                continue
            scale = max(np.abs(ref[kind][n]).max() for n in vec)
            for n in vec:
                _close(ref[kind][n], getattr(obj, n).numpy(), n, tol,
                       scale=scale)

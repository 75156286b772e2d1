"""One full resident PIC step: fbpic_tpu_torch against fbpic_tpu (float64).

An fbpic_tpu run with the resident column layout forced (sort_K) is
advanced a few steps; its state is carried into the port with
``utils.carry.state_from_numpy`` and both packages take the same single
step: once on an exchange step (removal, injection with fbpic_tpu's
column angles, fresh rho_prev, full column sort) and once on a banded
re-sort step.  Every particle array (in the resident (Nz, K) storage
order) must agree to 1e-12 relative; counters, grid edge and time
exactly; every spectral and interpolation field to 1e-8 relative: the
curl-free correction divides the difference of two deposited charge
grids by dt, which amplifies the float64 roundoff of the deposits
(~1e-14, summed in another order) by up to ~1e5 relative to the current
(measured 7e-10 on the banded step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

NZ_PHYS, NR, NM = 130, 16, 2
ZMAX, ZMIN, RMAX = 12.e-6, -4.e-6, 10.e-6
DT = (ZMAX - ZMIN) / NZ_PHYS / c
SIM_KW = dict(zmin=ZMIN, n_order=16,
              boundaries={"z": "open", "r": "reflective"},
              exchange_period=4, random_seed=0, verbose_level=0)
SPECIES_KW = dict(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6, p_zmax=100.e-6,
                  p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4,
                  continuous_injection=True, sort_K=256)
LASER_KW = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=6.e-6)
SPECT = ("Ep", "Em", "Ez", "Bp", "Bm", "Bz", "Jp", "Jm", "Jz", "rho_prev",
         "rho_next")
INTERP = ("Er", "Et", "Ez", "Br", "Bt", "Bz")
PARTICLE = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_column_angles(seed, dtype):
    """fbpic_tpu's injection angles (particles/injection.py:145-161)
    as a column-angle source for the port."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64

    def angles(iteration, species_index, nkey):
        root = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        key = jax.random.fold_in(root, species_index)
        key = jax.random.fold_in(key, jnp.asarray(iteration, jnp.int32))
        key_th = jax.random.fold_in(key, 1)
        phi = jax.vmap(lambda n: 2.0 * jnp.pi * jax.random.uniform(
            jax.random.fold_in(key_th, n), (), jdt))(
                jnp.asarray(nkey.cpu().numpy(), jnp.int32))
        return torch.as_tensor(np.array(phi))
    return angles


def jax_state_to_numpy(state):
    """fbpic_tpu SimState -> the arguments of state_from_numpy."""
    def opt(v, cast):
        return None if v is None else cast(np.asarray(v))

    species = []
    for sp in state.species:
        d = {n: np.asarray(getattr(sp, n)) for n in PARTICLE}
        for n in ("comp_x", "comp_y", "comp_z"):
            d[n] = opt(getattr(sp, n), np.asarray)
        d["next_free"] = opt(sp.next_free, int)
        d["inj_z_end"] = opt(sp.inj_z_end, float)
        species.append(d)
    return dict(
        spect={n: getattr(state.spect, n).to_numpy() for n in SPECT},
        interp={n: getattr(state.interp, n).to_numpy() for n in INTERP},
        species=species, time=float(state.time), zmin=float(state.zmin),
        iteration=int(state.iteration), mw_zref=float(state.mw_zref),
        sort_overflow=int(state.sort_overflow),
        ring_overwrite=int(state.ring_overwrite))


def _close(ref, out, name, tol):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    scale = np.abs(ref).max()
    if scale == 0:
        assert np.abs(out).max() == 0, name
    else:
        assert np.abs(out - ref).max() <= tol * scale, name


def _sims():
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    s0 = S0(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **SIM_KW)
    s0.use_fused_deposit = True          # force the resident layout
    s0.add_new_species(**SPECIES_KW)
    a0(s0, L0(**LASER_KW))
    s0.set_moving_window(v=c)
    s1 = S1(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
            dtype=torch.float64, **SIM_KW)
    s1.use_fused_deposit = True          # force the resident layout
    s1.add_new_species(**SPECIES_KW)
    a1(s1, L1(**LASER_KW))
    s1.set_moving_window(v=c)
    sc0, sc1 = s0.species_configs[0], s1.species_configs[0]
    assert sc0.resident and sc1.resident and sc0.resort == sc1.resort
    assert sc0.sort_K == sc1.sort_K and s0.config.Nz == s1.config.Nz
    assert s0.exchange_period == s1.exchange_period == 4
    return s0, s1


def test_one_resident_step_matches_jax():
    from fbpic_tpu.core.step import make_step_fn as m0
    from fbpic_tpu_torch.core.step import make_step_fn as m1
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    s0, s1 = _sims()
    step0 = jax.jit(m0(s0.config, tuple(s0.species_configs),
                       s0.build_options()))
    step1 = m1(s1.config, s1.species_configs, s1.build_options())
    angles = jax_column_angles(int(s0.state.seed), torch.float64)
    s0.step(8)                  # iteration 8: the next step is an exchange
    state0 = s0.state
    for _ in range(2):          # exchange step, then a banded re-sort step
        carried = jax_state_to_numpy(state0)
        state1 = state_from_numpy(**carried, device="cpu")
        state0 = step0(state0, s0.aux, tuple(s0._injector_auxes), (), (),
                       ())
        state1 = step1(state1, s1.aux, tuple(s1._injector_auxes), angles,
                       s1.generator)
        ref = jax_state_to_numpy(state0)
        assert state1.iteration == ref["iteration"]
        for n in ("time", "zmin", "mw_zref"):
            assert float(getattr(state1, n)) == ref[n], n
        assert int(state1.sort_overflow) == ref["sort_overflow"]
        assert int(state1.ring_overwrite) == ref["ring_overwrite"]
        for n in SPECT:
            _close(ref["spect"][n], getattr(state1.spect, n).numpy(), n,
                   1e-8)
        for n in INTERP:
            _close(ref["interp"][n], getattr(state1.interp, n).numpy(), n,
                   1e-8)
        sp_ref, sp = ref["species"][0], state1.species[0]
        assert sp.next_free == sp_ref["next_free"]
        assert float(sp.inj_z_end) == sp_ref["inj_z_end"]
        for n in PARTICLE:
            _close(sp_ref[n], getattr(sp, n).numpy(), n, 1e-12)
        # the particle set moved in the same slots
        np.testing.assert_array_equal(sp_ref["w"] != 0, sp.w.numpy() != 0)


def test_periodic_plasma_wave_steps_match_jax():
    """Periodic z (no window, no injection): a modulated plasma with a
    drift, resident in both packages (the full re-sort at iteration 0,
    banded re-sorts after), 10 steps; Ez to 1e-9 of its scale (float64;
    the correction's cancellation, see the module docstring, grows over
    the steps)."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    Nz, Nr, Nm = 48, 16, 2
    Lz, rmax = 20.e-6, 15.e-6
    kw = dict(zmin=0., boundaries={"z": "periodic", "r": "reflective"},
              random_seed=0, verbose_level=0)
    sp = dict(q=-e, m=m_e, n=1.e24, p_nz=2, p_nr=2, p_nt=4, uz_m=0.05,
              p_zmin=0., p_zmax=Lz, p_rmax=12.e-6, sort_K=256,
              dens_func=lambda z, r: 1. + 0.05 * np.sin(2 * np.pi * z / Lz))
    s0 = S0(Nz, Lz, Nr, rmax, Nm, Lz / Nz / 3.e8, **kw)
    s0.use_fused_deposit = True
    s0.add_new_species(**sp)
    s1 = S1(Nz, Lz, Nr, rmax, Nm, Lz / Nz / 3.e8, device="cpu",
            dtype=torch.float64, **kw)
    s1.use_fused_deposit = True
    s1.add_new_species(**sp)
    assert s0.species_configs[0].resident and s1.species_configs[0].resident
    s0.step(10)
    s1.step(10)
    _close(np.asarray(s0.state.interp.Ez.re),
           s1.state.interp.Ez.real.numpy(), "Ez", 1e-9)
    w0 = np.asarray(s0.state.species[0].w)
    np.testing.assert_array_equal(w0 != 0, s1.state.species[0].w.numpy() != 0)
    _close(np.asarray(s0.state.species[0].z), s1.state.species[0].z.numpy(),
           "z", 1e-12)

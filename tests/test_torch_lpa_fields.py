"""Mirrors and external fields: fbpic_tpu_torch against fbpic_tpu.

- ``_z_profile`` with mirrors (modes 'all', one mode, a list; a boosted
  mirror; with and without the open-z damping) and ``damp_EB_z`` (an
  (Nz,) and an (Nm, Nz) profile, with and without the radial PML's
  split fields) on numpy-seeded fields: 1e-12 of each output's largest
  value, float64.
- tests/test_laser.py::test_mirror_mode_filtering's configuration for
  one step in both packages (every E/B field to 1e-8 of its vector's
  largest value, tests/test_torch_step.py's field tolerance), and that
  test's own assertions on the port.
- tests/test_external_fields.py's configuration (Nz = 32, 40 steps)
  with two species and two external fields, one restricted to the first
  species (``species=``): on the ring path (float64, sort_K = 0) and on
  the resident layout (float64 with the fused deposit forced, as
  tests/test_torch_step.py does); every particle array to 1e-12 of its
  largest value, slot by slot, and that test's analytic uz on the port.
  The field function is plain arithmetic, so the same one runs on jnp
  and on torch arrays.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

PARTICLE = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")
EB = ("Er", "Et", "Ez", "Br", "Bt", "Bz")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(ref, out, name, tol):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    scale = np.abs(ref).max()
    if scale == 0:
        assert np.abs(out).max() == 0, name
    else:
        assert np.abs(out - ref).max() <= tol * scale, (
            name, np.abs(out - ref).max() / scale)


def _grid_sims(boundaries, use_pml=False):
    """A small grid in both packages (no species)."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    bnd = dict(boundaries)
    kw = dict(zmin=-2.e-6, n_order=16, verbose_level=0, random_seed=0)
    if use_pml:
        bnd["r"] = "open"
        kw["n_damp"] = {"z": 8, "r": 4}
    elif bnd["z"] == "open":
        kw["n_damp"] = {"z": 8, "r": 4}
    args = (40, 8.e-6, 12, 6.e-6, 2, 0.2e-6 / c)
    s0 = S0(*args, boundaries=bnd, **kw)
    s1 = S1(*args, boundaries=bnd, device="cpu", dtype=torch.float64, **kw)
    assert s0.config.Nz == s1.config.Nz
    return s0, s1


def _mirrors(mod, dt):
    M = mod.Mirror
    return {
        "all": [M(z_lab=1.e-6, n_cells=3)],
        "one_mode": [M(z_lab=2.e-6, n_cells=2, m=1)],
        "list_and_boosted": [M(z_lab=0.5e-6, n_cells=4, m=[0]),
                             M(z_lab=30.e-6, n_cells=2, gamma_boost=5.)],
    }


@pytest.mark.parametrize("z_bnd", ["open", "periodic"])
@pytest.mark.parametrize("which", ["all", "one_mode", "list_and_boosted"])
def test_z_profile_matches(which, z_bnd):
    from fbpic_tpu.core import step as st0
    from fbpic_tpu.lpa_utils import mirrors as mi0
    from fbpic_tpu_torch.core import step as st1
    from fbpic_tpu_torch.lpa_utils import mirrors as mi1
    s0, s1 = _grid_sims({"z": z_bnd, "r": "reflective"})
    time = 1.e-14
    o0 = st0.StepOptions(mirrors=tuple(_mirrors(mi0, s0.dt)[which]))
    o1 = st1.StepOptions(mirrors=tuple(_mirrors(mi1, s1.dt)[which]))
    zmin = s0.state.zmin
    p0 = st0._z_profile(s0.config, o0, s0.aux, zmin,
                        jnp.asarray(time, jnp.float64))
    p1 = st1._z_profile(s1.config, o1, s1.aux, np.float64(float(zmin)),
                        np.float64(time))
    assert p1.shape == (2, s1.config.Nz)
    _close(np.asarray(p0), p1.numpy(), which, 1e-12)
    # some cells zeroed, and (open z) the damping folded in
    assert (p1.numpy() == 0).any()
    if z_bnd == "open":
        assert ((p1.numpy() > 0) & (p1.numpy() < 1)).any()
    # no mirrors: the damping alone, or nothing
    no0 = st0._z_profile(s0.config, st0.StepOptions(), s0.aux, zmin, 0.)
    no1 = st1._z_profile(s1.config, st1.StepOptions(), s1.aux, 0., 0.)
    assert (no0 is None) == (no1 is None) == (z_bnd == "periodic")


@pytest.mark.parametrize("use_pml", [False, True])
@pytest.mark.parametrize("rank", [1, 2])
def test_damp_EB_z_matches(rank, use_pml):
    from fbpic_tpu.core import step as st0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.core import step as st1
    s0, s1 = _grid_sims({"z": "open", "r": "reflective"}, use_pml=use_pml)
    cfg = s1.config
    rng = np.random.RandomState(3)
    names = ["Ep", "Em", "Ez", "Bp", "Bm", "Bz"]
    if use_pml:
        names += ["Ep_pml", "Em_pml", "Bp_pml", "Bm_pml"]
    shape = (cfg.Nm, cfg.Nz, cfg.Nr)
    vals = {n: rng.randn(*shape) + 1j * rng.randn(*shape) for n in names}
    prof = rng.rand(cfg.Nz) if rank == 1 else rng.rand(cfg.Nm, cfg.Nz)
    sp0 = dataclasses.replace(s0.state.spect, **{
        n: CArr.from_numpy(v, jnp.float64) for n, v in vals.items()})
    sp1 = dataclasses.replace(s1.state.spect, **{
        n: torch.as_tensor(v) for n, v in vals.items()})
    out0 = st0.damp_EB_z(s0.config, s0.aux, sp0, jnp.asarray(prof))
    out1 = st1.damp_EB_z(cfg, s1.aux, sp1, torch.as_tensor(prof))
    for n in names:
        _close(getattr(out0, n).to_numpy(), getattr(out1, n).numpy(), n,
               1e-12)
    # the sources are not touched
    assert out1.Jp is sp1.Jp


def _mirror_sims(mirror_m):
    """tests/test_laser.py::test_mirror_mode_filtering's run, both
    packages, one step."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu.lpa_utils.mirrors import Mirror as M0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    from fbpic_tpu_torch.lpa_utils.mirrors import Mirror as M1
    Nz, Nr, Nm = 64, 16, 2
    Lz = 20.e-6
    dt = Lz / Nz / c
    laser = dict(a0=0.01, waist=5.e-6, tau=8.e-15, z0=10.e-6)
    s0 = S0(Nz, Lz, Nr, 15.e-6, Nm, dt, zmin=0., verbose_level=0)
    s1 = S1(Nz, Lz, Nr, 15.e-6, Nm, dt, zmin=0., verbose_level=0,
            device="cpu", dtype=torch.float64)
    a0(s0, L0(**laser))
    a1(s1, L1(**laser))
    interp = s0.state.interp
    Ez = interp.Ez
    s0.state = dataclasses.replace(s0.state, interp=dataclasses.replace(
        interp, Ez=type(Ez)(Ez.re.at[0].set(1.e9), Ez.im)))
    Ez1 = s1.state.interp.Ez.clone()
    Ez1[0] = torch.complex(torch.full_like(Ez1[0].real, 1.e9), Ez1[0].imag)
    s1.state = dataclasses.replace(s1.state, interp=dataclasses.replace(
        s1.state.interp, Ez=Ez1))
    s0.mirrors.append(M0(z_lab=0.0, n_cells=Nz, m=mirror_m))
    s1.mirrors.append(M1(z_lab=0.0, n_cells=Nz, m=mirror_m))
    s0.step(1, show_progress=False, correct_currents=False)
    s1.step(1, correct_currents=False)
    return s0, s1


@pytest.mark.parametrize("mirror_m", [[0], "all"])
def test_mirror_mode_filtering_step_matches(mirror_m):
    s0, s1 = _mirror_sims(mirror_m)
    for vec in (("Er", "Et", "Ez"), ("Br", "Bt", "Bz")):
        scale = max(np.abs(getattr(s0.state.interp, n).to_numpy()).max()
                    for n in vec)
        for n in vec:
            ref = getattr(s0.state.interp, n).to_numpy()
            err = np.abs(getattr(s1.state.interp, n).numpy() - ref).max()
            assert err <= 1e-8 * max(scale, 1e-300), (n, err, scale)
    interp = s1.state.interp
    m0 = interp.Er[0].real.abs().max() + interp.Ez[0].real.abs().max()
    m1 = interp.Er[1].real.abs().max()
    if mirror_m == "all":
        assert m0 < 1.0 and m1 < 1.0
    else:
        assert m0 < 1.0 and m1 > 1.e8


def field_func(F, x, y, z, t, amplitude, length_scale):
    """Plain arithmetic: runs on jnp and on torch arrays alike."""
    return F + amplitude * (1. + 0.1 * z / length_scale
                            + 0.05 * x / length_scale) * (1. + 1.e12 * t)


def _external_sims(resident):
    """tests/test_external_fields.py's box and species, plus a positron
    species; Ez on the electrons only, Bx on every species."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.external_fields import ExternalField as X0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.external_fields import \
        ExternalField as X1
    Nz, Nr, Nm = 32, 8, 1
    zmax, rmax = 3.2e-6, 4.e-6
    dt = zmax / Nz / c
    sp = dict(n=1.0, p_nz=1, p_nr=1, p_nt=1, p_zmin=0, p_zmax=zmax,
              p_rmin=0., p_rmax=2.e-6, continuous_injection=False)
    if resident:
        sp["sort_K"] = 128
    sims = []
    for S, X, kw in ((S0, X0, {}),
                     (S1, X1, dict(device="cpu", dtype=torch.float64))):
        sim = S(Nz, zmax, Nr, rmax, Nm, dt, random_seed=0, verbose_level=0,
                **kw)
        if resident:
            sim.use_fused_deposit = True
        elec = sim.add_new_species(q=-e, m=m_e, **sp)
        sim.add_new_species(q=e, m=m_e, uz_m=0.1, **sp)
        sim.external_fields.append(
            X(field_func, "Ez", 1.e9, 2.e-6, species=elec))
        sim.external_fields.append(X(field_func, "Bx", 0.5, 3.e-6))
        sims.append(sim)
    for sc0, sc1 in zip(sims[0].species_configs, sims[1].species_configs):
        assert sc0.resident == sc1.resident == resident
        assert sc0.sort_K == sc1.sort_K
    return sims


@pytest.mark.parametrize("resident", [False, True])
def test_external_fields_run_matches(resident):
    s0, s1 = _external_sims(resident)
    N = 40
    s0.step(N, show_progress=False)
    s1.step(N)
    for i in range(2):
        sp0, sp1 = s0.state.species[i], s1.state.species[i]
        for n in PARTICLE:
            _close(np.asarray(getattr(sp0, n)), getattr(sp1, n).numpy(),
                   f"species {i} {n}", 1e-12)
    # tests/test_external_fields.py's analytic momentum (the field adds
    # amplitude * (1 + small terms): 2e-2 of the plain-Ez value)
    dt = s1.dt
    uz = s1.ptcl[0].uz
    uz_expected = -e * 1.e9 * (N * dt) / (m_e * c)
    assert np.allclose(uz, uz_expected, rtol=2e-1)
    # the positrons see no Ez: only Bx rotates their initial uz = 0.1
    assert np.abs(s1.ptcl[1].uz - 0.1).max() < 1e-3

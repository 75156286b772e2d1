"""Laser profiles and the laser antenna: fbpic_tpu_torch against
fbpic_tpu (float64).

- Every laser profile of fbpic_tpu's ``lpa_utils/laser`` (a summed one
  and ``CustomSpectrumLaser`` on a spectrum file written to tmp_path,
  ``FromLasyFileLaser`` on a lasy file where h5py is installed): E_field
  on numpy-seeded points and ``squared_profile_integral`` to 1e-12 of
  the largest value.
- ``LaserAntenna.compute_series`` (lab frame and boosted frame) and
  ``add_antenna_current`` (inside the box, at its edge, outside it, and
  an iteration outside the block) to 1e-12.
- An antenna run (open z, vacuum, 25 steps, with and without the current
  correction) in both packages: every E/B field to 1e-8 of its vector's
  largest value (tests/test_torch_step.py's field tolerance), and the
  port's series blocks follow fbpic_tpu's step chunks.
- Direct injection of a Laguerre-Gauss and a donut-like Laguerre-Gauss
  profile, and the legacy ``add_laser`` (a backward pulse, direct and
  by antenna): the injected fields to 1e-12.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fbpic_tpu.constants import c  # noqa: E402

EB = ("Er", "Et", "Ez", "Br", "Bt", "Bz")
LAM0 = 0.8e-6


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
    assert scale > 0, name
    assert np.abs(out - ref).max() <= tol * scale, (
        name, np.abs(out - ref).max() / scale)


def _spectrum_file(tmp_path):
    lam = np.linspace(0.7e-6, 0.9e-6, 200)
    om, om0 = 2 * np.pi * c / lam, 2 * np.pi * c / LAM0
    inten = np.exp(-((om - om0) / (0.05 * om0)) ** 2)
    phase = 0.3 * ((om - om0) / (0.05 * om0)) ** 2
    fname = tmp_path / "spectrum.csv"
    np.savetxt(fname, np.stack([lam, inten, phase], axis=1))
    return str(fname)


def _profiles(mod, tmp_path):
    """The same profiles from fbpic_tpu's and the port's laser package."""
    kw = dict(a0=0.5, tau=10.e-15, z0=5.e-6)
    out = {
        "gaussian_chirped": mod.GaussianLaser(
            waist=6.e-6, zf=8.e-6, theta_pol=0.3, cep_phase=0.7,
            phi2_chirp=2.e-29, **kw),
        "laguerre_gauss": mod.LaguerreGaussLaser(
            p=1, m=2, waist=6.e-6, theta0=0.4, **kw),
        "donut": mod.DonutLikeLaguerreGaussLaser(
            p=1, m=-1, waist=6.e-6, **kw),
        "flattened": mod.FlattenedGaussianLaser(
            a0=0.5, w0=8.e-6, N=6, tau=10.e-15, z0=5.e-6),
        "fewcycle": mod.FewCycleLaser(
            a0=0.5, waist=5.e-6, tau_fwhm=5.e-15, z0=5.e-6,
            propagation_direction=-1),
        "custom_spectrum": mod.CustomSpectrumLaser(
            a0=0.5, waist=6.e-6, z0=5.e-6,
            spectrum_file=_spectrum_file(tmp_path)),
    }
    out["summed"] = (mod.GaussianLaser(waist=6.e-6, **kw)
                     + mod.LaguerreGaussLaser(p=0, m=1, waist=4.e-6, **kw))
    return out


def test_profiles_match(tmp_path):
    import fbpic_tpu.lpa_utils.laser as L0
    import fbpic_tpu_torch.lpa_utils.laser as L1
    assert sorted(L0.__all__) == sorted(L1.__all__)
    p0, p1 = _profiles(L0, tmp_path), _profiles(L1, tmp_path)
    rng = np.random.RandomState(5)
    x, y = rng.uniform(-10.e-6, 10.e-6, (2, 40, 30))
    z = rng.uniform(-5.e-6, 20.e-6, (40, 30))
    for name in p0:
        for t in (0.0, 17.e-15):
            for comp, (a, b) in enumerate(zip(p0[name].E_field(x, y, z, t),
                                              p1[name].E_field(x, y, z, t))):
                if np.abs(a).max() == 0:
                    assert np.abs(b).max() == 0
                    continue
                _close(a, b, f"{name} E{'xy'[comp]} t={t}", 1e-12)
    for name in ("gaussian_chirped", "laguerre_gauss", "flattened"):
        for attr in ("longitudinal_profile", "transverse_profile"):
            assert getattr(p0[name], attr).squared_profile_integral() == \
                getattr(p1[name], attr).squared_profile_integral()
    assert p0["custom_spectrum"].longitudinal_profile \
        .squared_profile_integral() == p1["custom_spectrum"] \
        .longitudinal_profile.squared_profile_integral()


def test_lasy_file_profile_matches(tmp_path):
    h5py = pytest.importorskip("h5py")
    from fbpic_tpu.lpa_utils.laser import FromLasyFileLaser as F0
    from fbpic_tpu_torch.lpa_utils.laser import FromLasyFileLaser as F1
    om0 = 2 * np.pi * c / LAM0
    t_ax = np.linspace(-40.e-15, 40.e-15, 160)
    r_ax = np.linspace(0., 20.e-6, 80)
    T, R = np.meshgrid(t_ax, r_ax, indexing="ij")
    env = 1.e9 * np.exp(-T**2 / 8.e-15**2 - R**2 / 6.e-6**2)
    fname = tmp_path / "lasy_pulse.h5"
    with h5py.File(fname, "w") as f:
        ds = f.create_group("data/0/meshes").create_dataset(
            "laserEnvelope", data=env[None].astype(complex))
        ds.attrs["angularFrequency"] = om0
        ds.attrs["gridSpacing"] = np.array([t_ax[1] - t_ax[0],
                                            r_ax[1] - r_ax[0]])
        ds.attrs["gridGlobalOffset"] = np.array([t_ax[0], r_ax[0]])
        ds.attrs["geometry"] = np.bytes_(b"thetaMode")
    rng = np.random.RandomState(6)
    x, y = rng.uniform(-10.e-6, 10.e-6, (2, 50))
    z = rng.uniform(0., 20.e-6, 50)
    a = F0(str(fname), t_start=-10.e-6 / c).E_field(x, y, z, 0.)
    b = F1(str(fname), t_start=-10.e-6 / c).E_field(x, y, z, 0.)
    _close(a[0], b[0], "lasy Ex", 1e-12)


def _antennas(boosted):
    from fbpic_tpu.lpa_utils.boosted_frame import BoostConverter as B0
    from fbpic_tpu.lpa_utils.laser import GaussianLaser as G0
    from fbpic_tpu.lpa_utils.laser.antenna_injection import \
        LaserAntenna as A0
    from fbpic_tpu_torch.lpa_utils.boosted_frame import BoostConverter as B1
    from fbpic_tpu_torch.lpa_utils.laser import GaussianLaser as G1
    from fbpic_tpu_torch.lpa_utils.laser.antenna_injection import \
        LaserAntenna as A1
    laser = dict(a0=0.5, waist=4.e-6, tau=6.e-15, z0=-4.e-6, zf=2.e-6,
                 theta_pol=0.2)
    r = (np.arange(16) + 0.5) * 0.5e-6
    args = (2.e-6, 0.0, np.zeros(3), r, 0.5e-6, 0.1e-6 / c, 3)
    return (A0(G0(**laser), *args, boost=B0(3.) if boosted else None),
            A1(G1(**laser), *args, boost=B1(3.) if boosted else None))


@pytest.mark.parametrize("boosted", [False, True])
def test_compute_series_and_add_current_match(boosted):
    from fbpic_tpu.lpa_utils.laser.antenna_injection import \
        add_antenna_current as add0
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.lpa_utils.laser.antenna_injection import \
        add_antenna_current as add1
    a0, a1 = _antennas(boosted)
    dz, it0, n = 0.1e-6, 7, 30
    s0 = a0.compute_series(it0 * a0.dt, n, dz)
    s0 = dataclasses.replace(s0, it0=jnp.asarray(it0, jnp.int32))
    s1 = a1.compute_series(it0 * a1.dt, n, dz, device="cpu", it0=it0)
    assert s1.J.shape == (2, n, 3, 16) and s1.J.dtype == torch.complex128
    _close(s0.Jr.to_numpy(), s1.Jr.numpy(), "Jr", 1e-12)
    _close(s0.Jt.to_numpy(), s1.Jt.numpy(), "Jt", 1e-12)
    np.testing.assert_array_equal(np.asarray(s0.z_pos), s1.z_pos)

    rng = np.random.RandomState(2)
    Nz = 24
    grids = [rng.randn(3, Nz, 16) + 1j * rng.randn(3, Nz, 16)
             for _ in range(2)]
    z_ant = s1.z_pos
    cases = [(it0 + 3, z_ant[3] - 10.3 * dz),      # inside
             (it0 + 12, z_ant[12] - 1.2 * dz),     # at the left edge
             (it0 + 5, z_ant[5] - (Nz - 0.6) * dz),  # the right edge
             (it0 + 9, z_ant[9] + 3 * dz),         # left of the box
             (it0 + n + 4, z_ant[-1] - 6.7 * dz),  # past the block
             (it0 - 2, z_ant[0] - 8.1 * dz)]       # before the block
    for it, zmin in cases:
        out0 = add0(CArr.from_numpy(grids[0], jnp.float64),
                    CArr.from_numpy(grids[1], jnp.float64), s0,
                    jnp.asarray(it, jnp.int32),
                    jnp.asarray(zmin, jnp.float64), dz, Nz)
        out1 = add1(torch.as_tensor(grids[0]), torch.as_tensor(grids[1]),
                    s1, it, np.float64(zmin), dz, Nz)
        for a, b in zip(out0, out1):
            _close(a.to_numpy(), b.numpy(), f"grid at it {it}", 1e-12)


def _antenna_sims(n_damp_z=16):
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    Nz, Nr, Nm = 100, 16, 2
    zmax, rmax = 10.e-6, 12.e-6
    dt = zmax / Nz / c
    z_a = 5.e-6
    laser = dict(a0=0.01, waist=4.e-6, tau=4.e-15, z0=z_a - 2 * c * 4.e-15,
                 zf=z_a)
    kw = dict(n_order=16, boundaries={"z": "open", "r": "reflective"},
              n_damp={"z": n_damp_z, "r": 8}, random_seed=0, verbose_level=0)
    s0 = S0(Nz, zmax, Nr, rmax, Nm, dt, **kw)
    s1 = S1(Nz, zmax, Nr, rmax, Nm, dt, device="cpu", dtype=torch.float64,
            **kw)
    a0(s0, L0(**laser), method="antenna", z0_antenna=z_a)
    a1(s1, L1(**laser), method="antenna", z0_antenna=z_a)
    return s0, s1


def _compare_EB(s0, s1, tol):
    for vec in (("Er", "Et", "Ez"), ("Br", "Bt", "Bz")):
        scale = max(np.abs(getattr(s0.state.interp, n).to_numpy()).max()
                    for n in vec)
        assert scale > 0
        for n in vec:
            ref = getattr(s0.state.interp, n).to_numpy()
            err = np.abs(getattr(s1.state.interp, n).numpy() - ref).max()
            assert err <= tol * scale, (n, err / scale)


@pytest.mark.parametrize("correct_currents", [False, True])
def test_antenna_run_matches(correct_currents, monkeypatch):
    from fbpic_tpu_torch.lpa_utils.laser import antenna_injection
    s0, s1 = _antenna_sims()
    blocks = []
    series = antenna_injection.LaserAntenna.compute_series

    def record(self, t0, n_steps, dz, **kw):
        blocks.append((kw["it0"], n_steps))
        return series(self, t0, n_steps, dz, **kw)

    monkeypatch.setattr(antenna_injection.LaserAntenna, "compute_series",
                        record)
    # a plain writer of period 10 cuts the blocks where fbpic_tpu cuts
    # its step chunks
    writer = type("W", (), dict(period=10, write=lambda self, sim: None))
    s0.checkpoints.append(writer())
    s1.checkpoints.append(writer())
    for n in (13, 12):
        s0.step(n, correct_currents=correct_currents, show_progress=False)
        s1.step(n, correct_currents=correct_currents)
    assert blocks == [(0, 10), (10, 3), (13, 7), (20, 5)]
    _compare_EB(s0, s1, 1e-8)
    # the spectral current, against its vector's largest value (the
    # linearly polarized antenna's Jp and Jz are roundoff)
    J = {n: getattr(s0.state.spect, n).to_numpy() for n in ("Jp", "Jm",
                                                             "Jz")}
    scale = max(np.abs(v).max() for v in J.values())
    for n, ref in J.items():
        err = np.abs(getattr(s1.state.spect, n).numpy() - ref).max()
        assert err <= 1e-8 * scale, (n, err / scale)


def _direct_sims(profile_fn):
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    import fbpic_tpu.lpa_utils.laser as L0
    import fbpic_tpu_torch.lpa_utils.laser as L1
    args = (64, 16.e-6, 16, 12.e-6, 3, 0.25e-6 / c)
    s0 = S0(*args, verbose_level=0)
    s1 = S1(*args, verbose_level=0, device="cpu", dtype=torch.float64)
    profile_fn(L0, s0)
    profile_fn(L1, s1)
    return s0, s1


@pytest.mark.parametrize("which", ["laguerre_gauss", "donut", "add_laser"])
def test_direct_injection_matches(which):
    def inject(L, sim):
        kw = dict(a0=0.1, tau=8.e-15, z0=8.e-6)
        if which == "laguerre_gauss":
            L.add_laser_pulse(sim, L.LaguerreGaussLaser(
                p=1, m=1, waist=5.e-6, theta0=0.3, **kw))
        elif which == "donut":
            L.add_laser_pulse(sim, L.DonutLikeLaguerreGaussLaser(
                p=0, m=1, waist=5.e-6, **kw))
        else:
            L.add_laser(sim, 0.1, 5.e-6, c * 8.e-15, 8.e-6, zf=6.e-6,
                        theta_pol=0.5, fw_propagating=False)
            L.add_laser(sim, 0.05, 4.e-6, c * 6.e-15, 6.e-6,
                        method="antenna", z0_antenna=4.e-6,
                        fw_propagating=False)
    s0, s1 = _direct_sims(inject)
    # each component against its vector's largest value (a linearly
    # polarized pulse's Ep is roundoff)
    for group, vectors in (("interp", (EB[:3], EB[3:])),
                           ("spect", (("Ep", "Em", "Ez"),
                                      ("Bp", "Bm", "Bz")))):
        g0, g1 = getattr(s0.state, group), getattr(s1.state, group)
        for vec in vectors:
            scale = max(np.abs(getattr(g0, n).to_numpy()).max()
                        for n in vec)
            for n in vec:
                err = np.abs(getattr(g1, n).numpy()
                             - getattr(g0, n).to_numpy()).max()
                assert err <= 1e-12 * scale, (n, err / scale)
    if which == "add_laser":
        (ant0,), (ant1,) = s0.laser_antennas, s1.laser_antennas
        assert ant1.profile.propag_direction == -1.0 == \
            ant0.profile.propag_direction
        assert (ant1.z0, ant1.v) == (ant0.z0, ant0.v) == (4.e-6, 0.0)

"""Particle bunches, space-charge initialization and the ballistic push:
fbpic_tpu_torch against fbpic_tpu.

- Every loader of ``lpa_utils.bunch`` (flat-top with a density function
  and a boost, Gaussian with an energy spread, ``symmetrize``, ``tf``,
  ``save_beam`` and a boost, from a text file, from arrays, and the
  ``add_elec_*`` wrappers), float64: the same seed gives the same
  particle arrays slot by slot (1e-15 of each array's largest value),
  the same capacity, sort_K = 0 and the same ballistic plane.
- The space-charge fields of a Gaussian bunch (and of a backward
  flat-top bunch) against fbpic_tpu's: every E/B component to 1e-10 of
  its vector's largest value.
- The ballistic-before-plane push: tests/test_beam_focusing.py's box
  with the plane through the bunch, 20 steps, every particle array to
  1e-12.
- A float32 run of a resident plasma beside a Gaussian bunch (the
  bunch a ring with sort_K = 0: the linear gather, the scatter J and
  the grid-difference d(rho) beside K1's plain version) against
  fbpic_tpu's float32 run in a subprocess with x64 off, at
  tests/test_torch_f32_parity.py's gates (periodic z: fbpic_tpu's
  float32 compile of the open-z step alone takes ~20 s here).
- ``add_particle_bunch_openPMD`` without openpmd_viewer and
  ``FromLasyFileLaser`` without h5py raise ImportError.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTICLE = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")


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


def _sims(**kw):
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu_torch import Simulation as S1
    args = (60, 20.e-6, 20, 15.e-6, 2, 0.2e-6 / c)
    kw = dict(dict(zmin=-10.e-6, random_seed=0, verbose_level=0), **kw)
    return (S0(*args, **kw),
            S1(*args, device="cpu", dtype=torch.float64, **kw))


def _compare_species(s0, s1, i, tol=1e-15):
    sp0, sp1 = s0.state.species[i], s1.state.species[i]
    assert sp0.x.shape[0] == sp1.capacity
    for n in PARTICLE:
        _close(np.asarray(getattr(sp0, n)), getattr(sp1, n).numpy(),
               f"species {i} {n}", tol)
    sc0, sc1 = s0.species_configs[i], s1.species_configs[i]
    assert sc1.sort_K == sc0.sort_K == 0 and not sc1.resident
    assert (sc1.ballistic_z0, sc1.ballistic_v) == (sc0.ballistic_z0,
                                                   sc0.ballistic_v)
    assert s1._species_counts[i] == s0._species_counts[i]


def _load_all(B, sim, tmp_path, tag):
    """Every loader of one package's bunch module into ``sim``."""
    import importlib
    boost = importlib.import_module(
        B.__package__ + ".boosted_frame").BoostConverter(2.)
    kw = dict(initialize_self_field=False)
    B.add_particle_bunch(
        sim, -e, m_e, 20., 1.e24, -5.e-6, 5.e-6, 0., 4.e-6, p_nr=2, p_nz=2,
        p_nt=4, dens_func=lambda z, r: 1. + 0.1 * np.cos(1.e6 * z),
        boost=boost, z_injection_plane=2.e-6, boost_positions_in_dens_func=True,
        **kw)
    B.add_particle_bunch_gaussian(
        sim, -e, m_e, 2.e-6, 3.e-6, 1.e-6, 50., 2., 1.e9, 2000, tf=1.e-13,
        zf=1.e-6, boost=boost, save_beam=str(tmp_path / f"beam_{tag}"),
        z_injection_plane=0., symmetrize=True, **kw)
    B.add_particle_bunch_gaussian(
        sim, e, 3 * m_e, 1.e-6, 2.e-6, 0., 10., 0., 1.e8, 501, **kw)
    fname = tmp_path / "bunch.txt"
    if not fname.exists():
        rng = np.random.RandomState(9)
        arr = np.stack([1.e-6 * rng.randn(300), 1.e-6 * rng.randn(300),
                        2.e-6 * rng.randn(300), rng.randn(300),
                        rng.randn(300), 30. + rng.randn(300)], axis=1)
        np.savetxt(fname, arr)
    B.add_particle_bunch_file(sim, -e, m_e, str(fname), 1.e8, z_off=1.e-6,
                              **kw)
    rng = np.random.RandomState(11)
    arrays = [1.e-6 * rng.randn(100) for _ in range(3)] + \
        [rng.randn(100), rng.randn(100), 5. + rng.randn(100),
         1.e5 * rng.rand(100)]
    B.add_particle_bunch_from_arrays(sim, -e, m_e, *arrays, boost=boost, **kw)
    B.add_elec_bunch_from_arrays(sim, *arrays, direction="backward",
                                 z_injection_plane=-3.e-6)


def test_loaders_match(tmp_path):
    import fbpic_tpu.lpa_utils.bunch as B0
    import fbpic_tpu.lpa_utils as U0
    import fbpic_tpu_torch.lpa_utils.bunch as B1
    import fbpic_tpu_torch.lpa_utils as U1
    assert sorted(U0.__all__) == sorted(U1.__all__)
    s0, s1 = _sims()
    _load_all(B0, s0, tmp_path, "jax")
    _load_all(B1, s1, tmp_path, "torch")
    assert len(s0.species_configs) == len(s1.species_configs) == 6
    for i in range(6):
        _compare_species(s0, s1, i)
    # fbpic_tpu's configs carried into the port keep the ballistic plane
    from fbpic_tpu_torch.utils.carry import species_configs_from
    assert species_configs_from(s0.species_configs) == s1.species_configs
    saved = [np.load(tmp_path / f"beam_{tag}.npz") for tag in ("jax",
                                                                "torch")]
    for k in saved[0].files:
        np.testing.assert_array_equal(saved[0][k], saved[1][k])
    # the electron wrappers: -e, m_e and Q / e
    s0, s1 = _sims()
    for B, sim in ((B0, s0), (B1, s1)):
        B.add_elec_bunch(sim, 10., 1.e24, -4.e-6, 4.e-6, 0., 3.e-6)
        B.add_elec_bunch_gaussian(sim, 1.e-6, 2.e-6, 1.e-6, 20., 1.,
                                  10.e-12, 400, zf=2.e-6)
        B.add_elec_bunch_file(sim, str(tmp_path / "bunch.txt"), 5.e-12)
    for i in range(3):
        _compare_species(s0, s1, i)
        assert s1.species_configs[i].q == -e


@pytest.mark.parametrize("which", ["gaussian", "flat_backward"])
def test_space_charge_fields_match(which):
    import fbpic_tpu.lpa_utils.bunch as B0
    import fbpic_tpu_torch.lpa_utils.bunch as B1
    s0, s1 = _sims(n_order=32)
    for B, sim in ((B0, s0), (B1, s1)):
        if which == "gaussian":
            B.add_particle_bunch_gaussian(
                sim, -e, m_e, 2.e-6, 2.e-6, 0.5e-6, 15., 0.5, 1.e8, 4000,
                zf=0., symmetrize=True)
        else:
            B.add_particle_bunch(sim, -e, m_e, 8., 1.e23, -4.e-6, 3.e-6,
                                 0., 5.e-6, direction="backward")
    _compare_species(s0, s1, 0)
    for vec in (("Er", "Et", "Ez"), ("Br", "Bt", "Bz")):
        ref = {n: getattr(s0.state.interp, n).to_numpy() for n in vec}
        scale = max(np.abs(v).max() for v in ref.values())
        assert scale > 0
        for n in vec:
            err = np.abs(getattr(s1.state.interp, n).numpy() - ref[n]).max()
            assert err <= 1e-10 * scale, (n, err / scale)


def test_ballistic_push_matches():
    """tests/test_beam_focusing.py's box and bunch (fewer particles),
    the plane through the bunch's middle: the particles behind it keep
    their momenta, those ahead feel the space charge."""
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.bunch import add_elec_bunch_gaussian as g0
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.bunch import add_elec_bunch_gaussian as g1
    Nz, zmax, zmin = 100, 0.e-6, -20.e-6
    Nr, rmax, Nm = 60, 15.e-6, 1
    dt = (zmax - zmin) / Nz / c
    kw = dict(zmin=zmin, boundaries={"z": "open", "r": "reflective"},
              random_seed=0, verbose_level=0)
    sims = [S0(Nz, zmax, Nr, rmax, Nm, dt, **kw),
            S1(Nz, zmax, Nr, rmax, Nm, dt, device="cpu", dtype=torch.float64,
               **kw)]
    for g, sim in zip((g0, g1), sims):
        g(sim, 1.e-6, 2.e-6, 0.1e-6, 10., sig_gamma=0., Q=200.e-12, N=2000,
          tf=0., zf=-10.e-6, z_injection_plane=-10.e-6)
        sim.set_moving_window(v=c)
    uz_start = sims[1].state.species[0].uz.clone()
    sims[0].step(20, show_progress=False)
    sims[1].step(20)
    _compare_species(*sims, 0, tol=1e-12)
    sp = sims[1].state.species[0]
    # the particles move forward: one behind the (lab-static) plane now
    # was behind it at every step
    behind = (sp.w != 0) & (sp.z <= -10.e-6)
    moved = (sp.uz != uz_start) & (sp.w != 0)
    assert behind.any() and moved.any()
    assert not (moved & behind).any()


JAX_SCRIPT = r'''
import sys
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from fbpic_tpu import Simulation
from fbpic_tpu.constants import c, e, m_e
from fbpic_tpu.lpa_utils.bunch import add_particle_bunch_gaussian
sim = Simulation(*%(grid)r, **%(kw)r)
add_particle_bunch_gaussian(sim, **%(bunch)r)
sc = sim.species_configs
assert sc[0].resident and sc[1].sort_K == 0 and not sc[1].resident
sim.step(%(n)d, show_progress=False)
Ez = sim.get_interp_field("Ez", 0).real
Er0 = sim.get_interp_field("Er", 0).real
Bt0 = sim.get_interp_field("Bt", 0).real
rho = sim.get_interp_field("rho", 0).real
np.savez(sys.argv[1], Ez_axis=Ez[:, 0], Er0_r5=Er0[:, 5], Bt0_r5=Bt0[:, 5],
         rho_axis=rho[:, 0], seed=int(sim.state.seed),
         uz=np.asarray(sim.state.species[1].uz))
'''
F32_GATES = {"Ez_axis": 1.5e-2, "Er0_r5": 1.5e-2, "Bt0_r5": 1.5e-2,
             "rho_axis": 3e-2}


def test_f32_plasma_and_bunch_match_jax_f32(tmp_path):
    """A resident plasma and a Gaussian bunch (a ring: the d(rho)
    fallback of two scatter deposits beside K1's plain version), float32
    in both packages, 20 steps in a periodic box.  No laser: mode 1
    holds roundoff only, so the gates read modes 0 (Ez, Er, Bt, rho)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_gaussian
    grid = (160, 16.e-6, 16, 12.e-6, 2, 0.1e-6 / c)
    kw = dict(p_zmin=0., p_zmax=16.e-6, p_rmin=0., p_rmax=10.e-6,
              p_nz=1, p_nr=1, p_nt=4, n_e=4.e24, zmin=0., n_order=32,
              boundaries={"z": "periodic", "r": "reflective"},
              random_seed=0, verbose_level=0)
    bunch = dict(q=-e, m=m_e, sig_r=1.5e-6, sig_z=1.5e-6, n_emit=1.e-6,
                 gamma0=200., sig_gamma=2., n_physical_particles=2.e8,
                 n_macroparticles=2000, zf=8.e-6, symmetrize=True)
    n_steps = 20
    out = tmp_path / "jax.npz"
    subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT % dict(
            repo=REPO, grid=grid, kw=kw, bunch=bunch, n=n_steps), str(out)],
        check=True, env=dict(os.environ, JAX_ENABLE_X64="0",
                             JAX_PLATFORMS="cpu"), timeout=600)
    ref = np.load(out)
    sim = Simulation(*grid, device="cpu", dtype=torch.float32, **kw)
    add_particle_bunch_gaussian(sim, **bunch)
    sc = sim.species_configs
    assert sc[0].resident and sc[1].sort_K == 0 and not sc[1].resident
    sim.step(n_steps)
    got = dict(Ez_axis=sim.get_interp_field("Ez", 0).real[:, 0],
               Er0_r5=sim.get_interp_field("Er", 0).real[:, 5],
               Bt0_r5=sim.get_interp_field("Bt", 0).real[:, 5],
               rho_axis=sim.get_interp_field("rho", 0).real[:, 0])
    for name, gate in F32_GATES.items():
        scale = np.abs(ref[name]).max()
        err = np.abs(got[name] - ref[name]).max()
        assert scale > 0 and err <= gate * scale, (name, err / scale)
    uz = sim.state.species[1].uz.numpy()
    assert np.abs(uz - ref["uz"]).max() <= 1e-5 * np.abs(ref["uz"]).max()


def test_missing_packages_raise_import_error(monkeypatch, tmp_path):
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch_openPMD
    from fbpic_tpu_torch.lpa_utils.laser import FromLasyFileLaser
    monkeypatch.setitem(sys.modules, "openpmd_viewer", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    sim = Simulation(16, 4.e-6, 8, 4.e-6, 1, 1.e-15, device="cpu",
                     dtype=torch.float64, verbose_level=0)
    with pytest.raises(ImportError, match="openpmd_viewer"):
        add_particle_bunch_openPMD(sim, -e, m_e, str(tmp_path))
    with pytest.raises(ImportError, match="h5py"):
        FromLasyFileLaser(str(tmp_path / "pulse.h5"))
    assert sim.species_configs == []

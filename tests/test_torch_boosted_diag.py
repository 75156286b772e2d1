"""Back-transformed (lab-frame) diagnostics: fbpic_tpu_torch against
fbpic_tpu (float64).

Fields, on examples/boosted_frame_script.py's smoke values (:29-31:
Nz = 256, Nr = 12, Nm = 2, n_order = 16, 1x1x4 particles per cell,
gamma_boost = 10, Galilean, 3 snapshots 50 fs apart; random_seed = 0
and fbpic_tpu's injection angles in the port):

- the captured slices: fbpic_tpu's state after 20, 40 and 60 steps
  (of the run below, with the diagnostic on) carried into the port
  (``utils.carry``), and the port's ``capture_slices`` held against
  fbpic_tpu's ``device_capture`` on it:
  ``valid`` exactly, ``z_lab`` to 1e-15, each slice to 1e-12 of its
  field's largest value over the whole grid (E and B are interpolated
  between two rows; rho and J come from interpolated inverse-DFT rows,
  a sum over all 552 z modes, whose roundoff scales with the whole
  field, not with the slice: a slice in a quiet region is 1e-5 of the
  field's peak);
- the lab snapshots: both packages step 80 steps in four ``step``
  calls of 20 with the diagnostic on (a lab cell fills every ~200 steps, so
  one per snapshot is reached); which cells are filled must agree
  exactly, their data to 1e-8 of each field's largest value (the runs'
  fields agree to 1e-8, tests/test_torch_boosted.py); then every
  snapshot is written and the files held against fbpic_tpu's as in
  tests/test_torch_diagnostics.py.

Particles, on tests/test_diagnostics.py:115-225's configurations: four
ballistic particles caught by the t_lab = 0 plane (the port's file
against fbpic_tpu's, and the analytic crossing of that test to 1e-3 dz),
and a drifting tracked plasma in a periodic box with two snapshots.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")
import jax  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

G = 10.
NZ, NR, NM, N_ORDER, PPC, NSNAP = 256, 12, 2, 16, (1, 1, 4), 3
ZMIN_LAB, ZMAX_LAB = -40.e-6, 0.e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Cap torch's CPU threads (the suite runs several test processes
    side by side) for the whole module: pytest sets the shared runs up
    before any function-scoped fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _boosted(pkg, **kw):
    """The smoke boosted_frame_script.py in package pkg."""
    import importlib
    sim_mod = importlib.import_module(pkg)
    bf = importlib.import_module(pkg + ".lpa_utils.boosted_frame")
    laser = importlib.import_module(pkg + ".lpa_utils.laser")
    boost = bf.BoostConverter(G)
    zmin, zmax = boost.static_length([ZMIN_LAB, ZMAX_LAB])
    dt = (zmax - zmin) / NZ / c
    n_e, = boost.static_density([1.e24])
    v_window, = boost.velocity([c])
    sim = sim_mod.Simulation(
        NZ, zmax, NR, 40.e-6, NM, dt, zmin=zmin, n_order=N_ORDER,
        gamma_boost=G, v_comoving=-c * np.sqrt(1. - 1. / G**2),
        use_galilean=True, boundaries={'z': 'open', 'r': 'reflective'},
        random_seed=0, **kw)
    sim.add_new_species(q=-e, m=m_e, n=n_e, p_zmin=0.,
                        p_zmax=boost.static_length([2000.e-6])[0],
                        p_rmax=35.e-6, p_nz=PPC[0], p_nr=PPC[1], p_nt=PPC[2],
                        continuous_injection=True,
                        boost_positions_in_dens_func=True)
    laser.add_laser_pulse(sim, laser.GaussianLaser(
        a0=2., waist=10.e-6, tau=30.e-15, z0=-15.e-6), gamma_boost=G)
    sim.set_moving_window(v=v_window)
    return sim


def _btd(pkg, sim, wdir):
    import importlib
    diag = importlib.import_module(pkg + ".diagnostics")
    return diag.BackTransformedFieldDiagnostic(
        ZMIN_LAB, ZMAX_LAB, c, dt_snapshots_lab=50.e-15,
        Ntot_snapshots_lab=NSNAP, gamma_boost=G, period=4,
        fldobject=sim.fld, comm=sim.comm, write_dir=wdir)


def _sims(tmp_path):
    from test_torch_step import jax_column_angles
    s0 = _boosted("fbpic_tpu")
    s1 = _boosted("fbpic_tpu_torch", device="cpu", dtype=torch.float64)
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    d0 = _btd("fbpic_tpu", s0, str(tmp_path / "jax"))
    d1 = _btd("fbpic_tpu_torch", s1, str(tmp_path / "torch"))
    return s0, s1, d0, d1


def _scaled_close(ref, out, tol, what, scale=None):
    if scale is None:
        scale = np.abs(ref).max(initial=0.0)
    err = np.abs(np.asarray(out) - ref).max(initial=0.0)
    assert err <= tol * max(scale, 1e-300), (what, err, scale)


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """Both packages' smoke run with the field BTD on, built once and
    stepped in four step() calls of 20 (the same in both; the capture
    reads the state and changes nothing in it; fbpic_tpu compiles its
    capturing chunk once for each chunk length).  After 20, 40 and 60
    steps fbpic_tpu's state is carried into a third simulation,
    a port one, whose ``capture_slices`` is held against fbpic_tpu's
    ``device_capture`` of the same state (the captured-slices test);
    the lab snapshots are held after 80 (the lab-snapshot test)."""
    from fbpic_tpu_torch.utils.carry import state_from_numpy
    from test_torch_step import jax_state_to_numpy
    tmp = tmp_path_factory.mktemp("btd")
    s0, s1, d0, d1 = _sims(tmp)
    carrier = _boosted("fbpic_tpu_torch", device="cpu", dtype=torch.float64)
    cap0 = jax.jit(d0.device_capture())
    s0.diags, s1.diags = [d0], [d1]
    carried = []
    for _ in range(4):
        s0.step(20, show_progress=False)
        s1.step(20)
        if s0.iteration == 80:
            break
        carrier.state = state_from_numpy(**jax_state_to_numpy(s0.state),
                                         device="cpu")
        ref = cap0(s0.state, s0.aux)
        ref = dict(valid=np.asarray(ref["valid"]),
                   z_lab=np.asarray(ref["z_lab"]),
                   slices={n: np.asarray(F.re) + 1j * np.asarray(F.im)
                           for n, F in ref["slices"].items()})
        out = [t.numpy() for t in d1.capture_slices(carrier)]
        scales = {n: np.abs(carrier.get_interp_field(n)).max()
                  for n in d1.names}
        carried.append((ref, out, scales))
    return d0, d1, carried, tmp


def test_captured_slices_match_fbpic_tpu(smoke_runs):
    _, d1, carried, _ = smoke_runs
    assert len(carried) == 3
    n_valid = 0
    for ref, (valid, z_lab, slices), scales in carried:
        np.testing.assert_array_equal(ref["valid"], valid)
        n_valid += int(valid.sum())
        _scaled_close(ref["z_lab"], z_lab, 1e-15, "z_lab")
        assert slices.shape == (len(d1.names), NM, NSNAP, NR)
        for f, name in enumerate(d1.names):
            _scaled_close(ref["slices"][name], slices[f], 1e-12, name,
                          scale=scales[name])
    assert n_valid > 0


def test_lab_snapshots_match_fbpic_tpu(smoke_runs):
    from test_torch_diagnostics import compare_h5
    d0, d1, _, tmp = smoke_runs
    n_filled = 0
    for a, b in zip(d0.snapshots, d1.snapshots):
        np.testing.assert_array_equal(a.filled, b.filled)
        n_filled += int(b.filled.sum())
        for name in a.names:
            _scaled_close(a.data[name], b.data[name], 1e-8, name)
    assert n_filled > 0
    for d in (d0, d1):
        for i, snap in enumerate(d.snapshots):
            d.flush_snapshot(i, snap)
    for i in range(NSNAP):
        compare_h5(*(os.path.join(str(tmp / tag), "hdf5",
                                  "data%08d.h5" % i)
                     for tag in ("jax", "torch")),
                   tolerance=lambda name: 1e-8)


# ---------------------------------------------------------------------
# Back-transformed particles
# ---------------------------------------------------------------------

def _bunch_port(sim, s0, index):
    """The port's copy of fbpic_tpu's bunch species ``index`` (its slots
    as fbpic_tpu's add_particle_bunch_from_arrays made them)."""
    from fbpic_tpu_torch.particles.state import make_particle_state
    sp0 = s0.state.species[index]
    view = sim.add_new_species(q=-e, m=m_e, continuous_injection=False)
    arrays = [np.asarray(getattr(sp0, n)) for n in
              ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w")]
    sim.state.species[view._index] = make_particle_state(
        *arrays, capacity=sp0.capacity, device="cpu", dtype=torch.float64)
    sim._species_counts[view._index] = s0._species_counts[index]
    return view


def _flush_all(diag):
    for i, snap in enumerate(diag.snapshots):
        if not snap["written"]:
            diag._flush(i, snap)
            snap["written"] = True


def test_btf_particles_crossing_match_fbpic_tpu(tmp_path):
    """tests/test_diagnostics.py::test_btf_particle_diag_crossing_
    interpolation in both packages."""
    import fbpic_tpu
    import fbpic_tpu_torch
    from fbpic_tpu.diagnostics import BackTransformedParticleDiagnostic as B0
    from fbpic_tpu_torch.diagnostics import \
        BackTransformedParticleDiagnostic as B1
    from fbpic_tpu.lpa_utils.bunch import add_particle_bunch_from_arrays
    from test_torch_diagnostics import compare_h5
    gamma_b = 10.0
    beta_b = np.sqrt(1.0 - 1.0 / gamma_b**2)
    Nzl, Nrl, Nml = 64, 8, 1
    zmaxl, zminl, rmaxl = 20.e-6, -20.e-6, 16.e-6
    dzl = (zmaxl - zminl) / Nzl
    dtl = dzl / c
    args = (Nzl, zmaxl, Nrl, rmaxl, Nml, dtl)
    s0 = fbpic_tpu.Simulation(*args, zmin=zminl, random_seed=0,
                              verbose_level=0)
    s1 = fbpic_tpu_torch.Simulation(*args, zmin=zminl, random_seed=0,
                                    verbose_level=0, device="cpu",
                                    dtype=torch.float64)
    z0 = np.array([-4.e-6, -6.e-6, -8.e-6, -10.e-6])
    x0 = np.array([1.e-6, 2.e-6, 0.5e-6, 1.5e-6])
    ux = np.array([0.5, -0.3, 0.2, 0.0])
    uz = np.array([0.3, 0.8, -0.2, 1.5])
    add_particle_bunch_from_arrays(s0, -e, m_e, x0, np.zeros(4), z0, ux,
                                   np.zeros(4), uz, np.full(4, 1.0),
                                   initialize_self_field=False)
    v1 = _bunch_port(s1, s0, len(s0.ptcl) - 1)
    diags = []
    for B, sim, view, tag in ((B0, s0, s0.ptcl[-1], "jax"),
                              (B1, s1, v1, "torch")):
        diags.append(B(zmin_lab=-1.e-3, zmax_lab=1.e-3, v_lab=0.,
                       dt_snapshots_lab=1.e-12, Ntot_snapshots_lab=1,
                       gamma_boost=gamma_b, period=1, sim=sim,
                       species={"bunch": view},
                       write_dir=str(tmp_path / tag)))
        sim.diags.append(diags[-1])
    s0.step(40, show_progress=False)
    s1.step(40)
    for d in diags:
        _flush_all(d)
    paths = [os.path.join(str(tmp_path / tag), "hdf5", "particles%08d.h5"
                          % 0) for tag in ("jax", "torch")]
    compare_h5(*paths)
    # the analytic lab-frame crossing of the t_lab = 0 plane
    ig = 1.0 / np.sqrt(1 + ux**2 + uz**2)
    vz = uz * ig * c
    t_star = -z0 / (vz + c / beta_b)
    z_lab_exp = gamma_b * (z0 + vz * t_star + beta_b * c * t_star)
    with h5py.File(paths[1], "r") as f:
        z_w = np.asarray(f["/data/0/particles/bunch/position/z"])
    assert len(z_w) == 4
    assert np.abs(np.sort(z_w) - np.sort(z_lab_exp)).max() < 1e-3 * dzl


def test_btf_particles_layout_match_fbpic_tpu(tmp_path):
    """tests/test_diagnostics.py::test_btf_particle_diag_openpmd_layout
    in both packages, the plasma tracked (ids in the snapshots)."""
    import fbpic_tpu
    import fbpic_tpu_torch
    from fbpic_tpu.diagnostics import BackTransformedParticleDiagnostic as B0
    from fbpic_tpu_torch.diagnostics import \
        BackTransformedParticleDiagnostic as B1
    from test_torch_diagnostics import (NZ as Nz, NR as Nr, NM as Nm, ZMAX,
                                        RMAX, DT, compare_h5)
    diags, sims = [], []
    for pkg, B, kw, tag in ((fbpic_tpu, B0, {}, "jax"),
                            (fbpic_tpu_torch, B1,
                             dict(device="cpu", dtype=torch.float64),
                             "torch")):
        sim = pkg.Simulation(Nz, ZMAX, Nr, RMAX, Nm, DT, random_seed=0, **kw)
        elec = sim.add_new_species(q=-e, m=m_e, n=1.e24, p_nz=1, p_nr=1,
                                   p_nt=4, p_zmin=0., p_zmax=ZMAX,
                                   p_rmax=6.e-6, uz_m=10.0)
        elec.track()
        diags.append(B(zmin_lab=0., zmax_lab=ZMAX, v_lab=0.,
                       dt_snapshots_lab=3 * DT, Ntot_snapshots_lab=2,
                       gamma_boost=5.0, period=1, sim=sim,
                       species={"electrons": elec},
                       write_dir=str(tmp_path / tag)))
        sim.diags.append(diags[-1])
        sims.append(sim)
    sims[0].step(8, show_progress=False)
    sims[1].step(8)
    for d in diags:
        _flush_all(d)
    n_ids = 0
    for i in range(2):
        paths = [os.path.join(str(tmp_path / tag), "hdf5",
                              "particles%08d.h5" % i)
                 for tag in ("jax", "torch")]
        compare_h5(*paths)
        with h5py.File(paths[1], "r") as f:
            n_ids += f["/data/%d/particles/electrons/id" % i].shape[0]
    assert n_ids > 0

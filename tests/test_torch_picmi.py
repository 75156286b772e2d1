"""fbpic_tpu_torch.picmi against fbpic_tpu.picmi (CPU, float64).

Each setup is built from the same PICMI objects through both packages
(the port's ``picmi.Simulation`` with ``device="cpu"``,
``dtype=torch.float64``), with the same host RNG (the PICMI wrapper
passes no random_seed, in both packages, so each test seeds the
simulation it built) and fbpic_tpu's injection angles fed to the port's
``column_angles`` (tests/test_torch_step.py::jax_column_angles).

Tolerances are tests/test_torch_step.py's: every E / B / rho field to
1e-8 of its scale (the curl-free correction amplifies the float64
roundoff of the deposits), particle positions and weights to 1e-12 of
their scale; the momenta to 1e-12 of their vector's scale (a linearly
polarized pulse leaves the other transverse momentum at roundoff).

- (a) tests/test_picmi.py's setup, 10 steps;
- (b) the same with Nz != Nr and bounds that differ in r and z: the
  grid's axis order (fbpic_tpu reads ``number_of_cells`` as [Nz, Nr]
  and the bounds and boundary conditions as [r, z]);
- (c) a Gaussian bunch (PseudoRandomLayout), a ConstantAppliedField, a
  Mirror and a ParticleDiagnostic in a periodic box, 6 steps;
- (d) the AnalyticDistribution expression: numpy in the port, jax.numpy
  in fbpic_tpu, within a few float64 ulps on the same (z, r) points;
- (e) the refusals raise the same exception types in both packages,
  and the port's default device is the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from scipy.constants import c  # noqa: E402

FIELDS = ("Er", "Et", "Ez", "Br", "Bt", "Bz")
#: tests/test_torch_step.py's tolerances
TOL_FIELDS, TOL_PARTICLES = 1e-8, 1e-12


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _packages():
    from fbpic_tpu import picmi as p0
    from fbpic_tpu_torch import picmi as p1
    return p0, p1


def _simulation(picmi, grid, port, **kw):
    solver = picmi.ElectromagneticSolver(
        grid=grid, method="PSATD", cfl=1.0,
        source_smoother=picmi.BinomialSmoother(n_pass=1,
                                               compensation=False))
    if port:
        kw.update(device="cpu", dtype=torch.float64)
    sim = picmi.Simulation(solver=solver, particle_shape="linear", **kw)
    sim.sim.verbose_level = 0
    sim.sim._rng = np.random.RandomState(0)
    return sim


def lwfa_setup(picmi, port, cells, lower, upper, write_dir):
    """tests/test_picmi.py:9-40 with the grid's cells and bounds given."""
    grid = picmi.CylindricalGrid(
        number_of_cells=list(cells), lower_bound=list(lower),
        upper_bound=list(upper),
        lower_boundary_conditions=["reflective", "open"],
        upper_boundary_conditions=["reflective", "open"],
        n_azimuthal_modes=2, moving_window_velocity=[0., c])
    sim = _simulation(picmi, grid, port)
    plasma = picmi.Species(
        particle_type="electron", name="plasma",
        initial_distribution=picmi.AnalyticDistribution(
            density_expression="1e24*exp(-(r/3e-6)**2)",
            lower_bound=[None, None, 8.e-6],
            upper_bound=[None, None, None], fill_in=True))
    sim.add_species(plasma, layout=picmi.GriddedLayout(
        grid=grid, n_macroparticle_per_cell={"r": 1, "z": 1, "theta": 4}))
    sim.add_laser(picmi.GaussianLaser(
        wavelength=0.8e-6, waist=4.e-6, duration=8.e-15,
        focal_position=[0, 0, 5.e-6], centroid_position=[0, 0, 5.e-6],
        a0=0.5, polarization_direction=[0, 1, 0]), injection_method=None)
    sim.add_diagnostic(picmi.FieldDiagnostic(grid=grid, period=10,
                                             write_dir=write_dir))
    return sim


def _close(ref, out, name, tol, scale=None):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape, name
    scale = np.abs(ref).max() if scale is None else scale
    assert scale > 0, name
    err = np.abs(out - ref).max() / scale
    assert err <= tol, (name, err)


def _feed_angles(s0, s1):
    from test_torch_step import jax_column_angles
    s1.sim.column_angles = jax_column_angles(int(s0.sim.state.seed),
                                             torch.float64)


def compare_runs(s0, s1):
    """Fields (E, B, rho of both modes) and the particles of every
    species, slot by slot."""
    for n in FIELDS:
        _close(getattr(s0.sim.state.interp, n).to_numpy(),
               getattr(s1.sim.state.interp, n).numpy(), n, TOL_FIELDS)
    for m in (0, 1):
        _close(s0.sim.get_interp_field("rho", m),
               s1.sim.get_interp_field("rho", m), f"rho {m}", TOL_FIELDS)
    for i, (sp0, sp1) in enumerate(zip(s0.sim.state.species,
                                       s1.sim.state.species)):
        w0 = np.asarray(sp0.w)
        np.testing.assert_array_equal(w0 != 0, sp1.w.numpy() != 0)
        for n in ("x", "y", "z", "w", "inv_gamma"):
            _close(getattr(sp0, n), getattr(sp1, n).numpy(), f"{i} {n}",
                   TOL_PARTICLES)
        u0 = {n: np.asarray(getattr(sp0, n)) for n in ("ux", "uy", "uz")}
        scale = np.sqrt(sum(u ** 2 for u in u0.values())).max()
        for n, u in u0.items():
            _close(u, getattr(sp1, n).numpy(), f"{i} {n}", TOL_PARTICLES,
                   scale)


def test_picmi_lwfa_setup_matches_fbpic_tpu(tmp_path):
    """(a) tests/test_picmi.py's setup, 10 steps in both packages."""
    p0, p1 = _packages()
    cells, lower, upper = (100, 20), (0., 0.), (10.e-6, 10.e-6)
    s0 = lwfa_setup(p0, False, cells, lower, upper, str(tmp_path / "jax"))
    s1 = lwfa_setup(p1, True, cells, lower, upper, str(tmp_path / "port"))
    _feed_angles(s0, s1)
    s0.step(10)
    s1.step(10)
    assert s0.sim.iteration == s1.sim.iteration == 10
    compare_runs(s0, s1)
    # the FieldDiagnostic wrote the same records at 0 and 10
    for it in (0, 10):
        name = "hdf5/data%08d.h5" % it
        with h5py.File(tmp_path / "jax" / name, "r") as f0, \
                h5py.File(tmp_path / "port" / name, "r") as f1:
            path = "/data/%d/fields/E/z" % it
            _close(f0[path][:], f1[path][:], path, TOL_FIELDS)


def test_picmi_grid_axis_order(tmp_path):
    """(b) Nz != Nr and bounds that differ in r and z: number_of_cells
    is [Nz, Nr], the bounds [r, z], in both packages; 4 steps agree."""
    p0, p1 = _packages()
    cells, lower, upper = (96, 24), (0., -2.e-6), (12.e-6, 10.e-6)
    s0 = lwfa_setup(p0, False, cells, lower, upper, str(tmp_path / "jax"))
    s1 = lwfa_setup(p1, True, cells, lower, upper, str(tmp_path / "port"))
    for s in (s0.sim, s1.sim):
        assert s.Nz_phys == 96 and s.config.Nr == 24
        assert s.config.rmax == 12.e-6
        assert np.isclose(s.config.dz, 12.e-6 / 96, rtol=1e-15)
        assert s.boundaries == {"z": "open", "r": "reflective"}
    assert s0.sim.config.Nz == s1.sim.config.Nz
    np.testing.assert_array_equal(s0.sim.grid_z(), s1.sim.grid_z())
    assert np.isclose(s1.sim.grid_z()[0], -2.e-6 + 0.5 * 12.e-6 / 96,
                      rtol=1e-12)
    _feed_angles(s0, s1)
    s0.step(4)
    s1.step(4)
    compare_runs(s0, s1)


def bunch_setup(picmi, port, write_dir):
    """A Gaussian electron bunch of 2000 macroparticles in a periodic
    box, pushed by a ConstantAppliedField, with a Mirror and a
    ParticleDiagnostic every 3 steps."""
    grid = picmi.CylindricalGrid(
        number_of_cells=[64, 16], lower_bound=[0., 0.],
        upper_bound=[8.e-6, 16.e-6],
        lower_boundary_conditions=["reflective", "periodic"],
        upper_boundary_conditions=["reflective", "periodic"],
        n_azimuthal_modes=2)
    sim = _simulation(picmi, grid, port)
    bunch = picmi.Species(
        particle_type="electron", name="bunch",
        initial_distribution=picmi.GaussianBunchDistribution(
            n_physical_particles=1.e8, rms_bunch_size=[1.e-6, 1.e-6, 1.e-6],
            centroid_position=[0., 0., 6.e-6],
            centroid_velocity=[0., 0., 0.99 * c]))
    sim.add_species(bunch, layout=picmi.PseudoRandomLayout(
        n_macroparticles=2000))
    sim.add_applied_field(picmi.ConstantAppliedField(Ez=-1.e10, Bx=0.2))
    sim.add_applied_field(picmi.Mirror(z_front_location=14.e-6, n_cells=2))
    sim.add_diagnostic(picmi.ParticleDiagnostic(
        period=3, species=[bunch], write_dir=write_dir))
    return sim


def test_picmi_bunch_fields_mirror_diagnostic(tmp_path):
    """(c) the bunch, the applied field, the mirror and the particle
    diagnostic, 6 steps in both packages."""
    p0, p1 = _packages()
    s0 = bunch_setup(p0, False, str(tmp_path / "jax"))
    s1 = bunch_setup(p1, True, str(tmp_path / "port"))
    assert len(s0.sim.external_fields) == len(s1.sim.external_fields) == 2
    assert len(s1.sim.mirrors) == 1
    s0.step(6)
    s1.step(6)
    compare_runs(s0, s1)
    for it in (0, 3, 6):
        name = "hdf5/data%08d.h5" % it
        with h5py.File(tmp_path / "jax" / name, "r") as f0, \
                h5py.File(tmp_path / "port" / name, "r") as f1:
            path = "/data/%d/particles/bunch/momentum/z" % it
            _close(f0[path][:], f1[path][:], path, TOL_PARTICLES)


#: Uses every name of the expression namespace: z, r, np, pi, the nine
#: functions and two user keywords
EXPRESSION = ("n0*where(z < L, maximum(z, 0.)/L, 1.)*exp(-(r/w0)**2)"
              "*(1.5 + 0.1*sin(2*pi*z/L) + 0.1*cos(r/w0)"
              " + 0.1*tanh(z/L) - 0.1*abs(sqrt(r/w0))"
              " + 0.1*minimum(z/L, 2.) + 0.1*np.log1p(r/w0))")


def _captured_dens_func(picmi, port):
    grid = picmi.CylindricalGrid(
        number_of_cells=[32, 8], lower_bound=[0., 0.],
        upper_bound=[10.e-6, 10.e-6],
        lower_boundary_conditions=["reflective", "periodic"],
        upper_boundary_conditions=["reflective", "periodic"])
    sim = _simulation(picmi, grid, port)
    calls = []
    sim.sim.add_new_species = lambda **kw: calls.append(kw)
    sim.add_species(picmi.Species(
        particle_type="electron", name="e",
        initial_distribution=picmi.AnalyticDistribution(
            density_expression=EXPRESSION, n0=2.e24, L=8.e-6, w0=5.e-6)),
        layout=picmi.GriddedLayout(n_macroparticle_per_cell=[1, 4, 1]))
    (kw,) = calls
    assert kw["n"] == 1.0
    return kw["dens_func"]


def test_analytic_distribution_namespace():
    """(d) numpy (port) against jax.numpy (fbpic_tpu) on the same
    points: within 4 float64 ulps."""
    p0, p1 = _packages()
    rng = np.random.RandomState(5)
    z = rng.uniform(-2.e-6, 20.e-6, 4096)
    r = rng.uniform(0., 12.e-6, 4096)
    ref = np.asarray(_captured_dens_func(p0, False)(z, r))
    out = _captured_dens_func(p1, True)(z, r)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    assert (ref[z < 0] == 0).all() and (out[z < 0] == 0).all()
    live = z > 0
    np.testing.assert_array_max_ulp(ref[live], out[live], maxulp=4)


def _refusal(picmi, port, what):
    grid = picmi.CylindricalGrid(
        number_of_cells=[32, 8], lower_bound=[0., 0.],
        upper_bound=[10.e-6, 10.e-6],
        lower_boundary_conditions=["reflective", "periodic"],
        upper_boundary_conditions=["reflective", "periodic"])
    sim = _simulation(picmi, grid, port)
    if what == "lab_frame_particle_diagnostic":
        sim.add_diagnostic(picmi.LabFrameParticleDiagnostic(
            grid=grid, num_snapshots=2, dt_snapshots=1e-14))
    elif what == "analytic_applied_field":
        sim.add_applied_field(picmi.AnalyticAppliedField(
            Ez_expression="1e9*z"))
    elif what == "laser_not_gaussian":
        sim.add_laser(picmi.LaserAntenna(position=[0, 0, 1.e-6]))
    elif what == "unsupported_distribution":
        sim.add_species(picmi.Species(
            particle_type="electron", name="e",
            initial_distribution=picmi.GriddedLayout([1, 1, 1])),
            layout=None)
    elif what == "write_input_file":
        sim.write_input_file("picmi_input")


@pytest.mark.parametrize("what,error", [
    ("lab_frame_particle_diagnostic", ValueError),
    ("analytic_applied_field", ValueError),
    ("laser_not_gaussian", ValueError),
    ("unsupported_distribution", ValueError),
    ("write_input_file", NotImplementedError),
])
def test_refusals_match_fbpic_tpu(what, error):
    """(e) the reference's refusals, kept."""
    p0, p1 = _packages()
    for picmi, port in ((p0, False), (p1, True)):
        with pytest.raises(error):
            _refusal(picmi, port, what)


def test_gaussian_bunch_default_count():
    """(e) a GaussianBunchDistribution without a PseudoRandomLayout
    gets 10,000 macroparticles, in both packages."""
    p0, p1 = _packages()
    counts = []
    for picmi, port in ((p0, False), (p1, True)):
        grid = picmi.CylindricalGrid(
            number_of_cells=[32, 8], lower_bound=[0., 0.],
            upper_bound=[10.e-6, 10.e-6],
            lower_boundary_conditions=["reflective", "periodic"],
            upper_boundary_conditions=["reflective", "periodic"])
        sim = _simulation(picmi, grid, port)
        view = sim.add_species(picmi.Species(
            particle_type="electron", name="b",
            initial_distribution=picmi.GaussianBunchDistribution(
                n_physical_particles=1.e7,
                rms_bunch_size=[1.e-6, 1.e-6, 1.e-6],
                centroid_position=[0., 0., 5.e-6],
                centroid_velocity=[0., 0., 0.9 * c])),
            layout=picmi.GriddedLayout([1, 1, 1]))
        counts.append(view.Ntot)
    assert counts == [10000, 10000]


def test_port_picmi_default_device_is_the_card():
    """picmi.Simulation passes its default device ("cuda") on: without
    CUDA it raises, it never runs on the CPU by itself."""
    from fbpic_tpu_torch import picmi
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    grid = picmi.CylindricalGrid(
        number_of_cells=[32, 8], lower_bound=[0., 0.],
        upper_bound=[10.e-6, 10.e-6],
        lower_boundary_conditions=["reflective", "periodic"],
        upper_boundary_conditions=["reflective", "periodic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        picmi.Simulation(solver=picmi.ElectromagneticSolver(grid=grid))

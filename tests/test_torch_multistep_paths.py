"""The chunk runner (core/graph.py) on the paths that read host values
a step in the eager loop: the back-transformed field diagnostic's
capture (``make_multi_step_capture``), laser antennas, mirrors,
external fields and ring (non-resident) species.  CPU, at
tests/test_torch_multistep.py's scale (internal Nz 64, Nr 16, Nm 2).

- (a) The Galilean boosted box with a ring species and the field BTD
  (3 snapshots): fbpic_tpu's ``make_multi_step_capture`` and the
  port's over 16 steps from the same prepared state, float64: each
  step's ``valid`` exactly, ``z_lab`` to 1e-15, the slices to 1e-8 of
  their field's largest value and the filled lab cells of both
  diagnostics' ``process_chunk`` (tests/test_torch_boosted_diag.py's
  tolerances for fields after a run).
- (b, c) The lab LWFA with a ring species (fbpic_tpu's float64 CPU
  default: scatter deposits), its laser emitted by an antenna, a mirror
  and an external Ez: fbpic_tpu's ``Simulation.step`` (its
  ``make_multi_step`` chunks, cut by a plain writer of period 5) against
  the port's, which runs the chunk runner, over step(10) + step(5): the
  antenna blocks alike, fields to 1e-8 and particles to 1e-12 of their
  scale (tests/test_torch_step.py's tolerances), the host values and
  counters equal.
- (d) Every step with the host's numbers against the same step with
  the chunk runner's StepScalars (its own tables: the antenna's row,
  cells and weights, the mirror's interval, the external field's time,
  the ring's grid edges), atol 0, float32 and float64; then the chunk
  runner against the eager loop over the same steps, atol 0.
- (e) ``graph_blockers`` of each configuration: every one takes the
  chunk runner, the processes and a ballistic species included (on the
  CPU any draw source does; tests/test_torch_multistep_processes.py
  holds the one blocker left, on CUDA).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from fbpic_tpu.constants import c, e, m_e  # noqa: E402
from test_torch_step import (  # noqa: E402
    jax_column_angles, jax_state_to_numpy, _close, SPECT, INTERP, PARTICLE)
from test_torch_multistep import (  # noqa: E402
    NZ_PHYS, NR, NM, ZMAX, RMAX, DT, SIM_KW, SPECIES_KW, LASER_KW, GAMMA,
    _assert_states_equal)

#: A ring: no column sort (fbpic_tpu's float64 CPU default)
RING_KW = dict(SPECIES_KW, sort_K=0)
Z_ANT = -1.e-6
ANT_LASER = dict(a0=0.5, waist=4.e-6, tau=8.e-15,
                 z0=Z_ANT - 2 * c * 8.e-15, zf=Z_ANT)
Z_MIRROR, EXT_EZ = 1.e-6, 1.e9
#: The BTD of the Galilean box: 3 snapshots whose planes cross the box
#: during the run
BTD_KW = dict(zmin_lab=-5.e-6, zmax_lab=25.e-6, v_lab=c,
              dt_snapshots_lab=10 * 1.e-6 / c, Ntot_snapshots_lab=3,
              gamma_boost=GAMMA, period=4)
N_BTD, LAB_CALLS = 16, (10, 5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Cap torch's CPU threads (the suite runs several test processes
    side by side) for the whole module: pytest sets the shared runs up
    before any function-scoped fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def ext_ez(F, x, y, z, t, amplitude, length_scale):
    """An external Ez growing with time (plain arithmetic: jnp and torch
    alike)."""
    return F + amplitude * (1. + t / DT * 1e-2)


def _sim(pkg, frame="lab", dtype=torch.float64, antenna=False,
         extras=False):
    """The small box in package pkg with a ring species: the lab LWFA
    (its laser injected, or emitted by an antenna; extras: a mirror and
    an external Ez), or the Galilean boosted box."""
    import importlib
    mod = importlib.import_module(pkg)
    laser = importlib.import_module(pkg + ".lpa_utils.laser")
    lpa = importlib.import_module(pkg + ".lpa_utils")
    kw = dict(SIM_KW)
    if pkg == "fbpic_tpu_torch":
        kw.update(device="cpu", dtype=dtype)
    boost = {}
    if frame == "galilean":
        kw.update(gamma_boost=GAMMA, v_comoving=-c * np.sqrt(
            1. - 1. / GAMMA**2), use_galilean=True)
        boost = dict(gamma_boost=GAMMA)
    sim = mod.Simulation(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **kw)
    sim.add_new_species(**RING_KW)
    if antenna:
        laser.add_laser_pulse(sim, laser.GaussianLaser(**ANT_LASER),
                              method="antenna", z0_antenna=Z_ANT)
    else:
        laser.add_laser_pulse(sim, laser.GaussianLaser(**LASER_KW), **boost)
    sim.set_moving_window(v=c, **boost)
    if extras:
        sim.mirrors.append(lpa.Mirror(z_lab=Z_MIRROR, n_cells=2))
        sim.external_fields.append(lpa.ExternalField(ext_ez, "Ez", EXT_EZ,
                                                     1.))
    return sim


def _pair(**kw):
    s0 = _sim("fbpic_tpu", **kw)
    s1 = _sim("fbpic_tpu_torch", **kw)
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    assert not s1.species_configs[0].resident
    assert s1.species_configs[0].sort_K == 0
    return s0, s1


def _btd(pkg, sim):
    import importlib
    diag = importlib.import_module(pkg + ".diagnostics")
    return diag.BackTransformedFieldDiagnostic(fldobject=sim.fld,
                                               comm=sim.comm, **BTD_KW)


# ---------------------------------------------------------------------
# (a) the BTD captured inside the chunk
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def btd_runs():
    from fbpic_tpu.core.step import make_multi_step_capture as mmsc0, \
        make_prepare as mp0
    from fbpic_tpu_torch.core.step import make_multi_step_capture, prepare
    s0, s1 = _pair(frame="galilean")
    d0, d1 = _btd("fbpic_tpu", s0), _btd("fbpic_tpu_torch", s1)
    o0, o1 = s0.build_options(), s1.build_options()
    inj0 = tuple(s0._injector_auxes)
    st0 = mp0(s0.config, tuple(s0.species_configs), o0)(
        s0.state, s0.aux, inj0, (), (), ())
    run0 = mmsc0(s0.config, tuple(s0.species_configs), o0,
                 (d0.device_capture(),))
    _, (raw0,) = run0(st0, s0.aux, N_BTD, inj0)
    st1 = prepare(s1.config, o1, s1.species_configs, s1.state, s1.aux)
    run1 = make_multi_step_capture(s1.config, s1.species_configs, o1,
                                   (d1.device_capture(),))
    _, counts = run1(st1, s1.aux, N_BTD, tuple(s1._injector_auxes),
                     s1.column_angles, s1.generator)
    d0.process_chunk(s0, raw0)
    cap0 = dict(valid=np.asarray(raw0["valid"]),
                z_lab=np.asarray(raw0["z_lab"]),
                slices={n: np.asarray(v.re) + 1j * np.asarray(v.im)
                        for n, v in raw0["slices"].items()})
    d1.process_chunk(s1, counts["captures"][0])
    return cap0, counts["captures"][0], d0, d1, s1


def test_btd_slices_match_fbpic_capture(btd_runs):
    cap0, (valid, z_lab, slices), _, d1, s1 = btd_runs
    S = BTD_KW["Ntot_snapshots_lab"]
    assert valid.shape == (N_BTD, S)
    assert slices.shape == (N_BTD, len(d1.names), NM, S, NR)
    np.testing.assert_array_equal(cap0["valid"], valid)
    assert valid.sum() >= N_BTD          # planes cross the box
    _close(cap0["z_lab"], z_lab, "z_lab", 1e-15)
    for f, name in enumerate(d1.names):
        ref = cap0["slices"][name]
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(slices[:, f] - ref)[valid.repeat(
            NM * NR).reshape(N_BTD, S, NM, NR).transpose(0, 2, 1, 3)]
        assert err.max() <= 1e-8 * scale, (name, err.max() / scale)


def test_btd_snapshots_match_fbpic(btd_runs):
    _, _, d0, d1, _ = btd_runs
    filled = 0
    for a, b in zip(d0.snapshots, d1.snapshots):
        np.testing.assert_array_equal(a.filled, b.filled)
        filled += int(b.filled.sum())
        for name in b.names:
            scale = max(np.abs(a.data[name]).max(), 1e-300)
            assert np.abs(a.data[name] - b.data[name]).max() \
                <= 1e-8 * scale, name
    assert filled >= 1


# ---------------------------------------------------------------------
# (b, c) the antenna, a mirror and an external field on a ring species
# ---------------------------------------------------------------------

class _Writer:
    """A plain writer of period 5: it ends the chunks of both packages
    (and the antenna's blocks) at the same iterations."""
    period = 5

    def write(self, sim):
        pass


@pytest.fixture(scope="module")
def lab_runs():
    from fbpic_tpu_torch.lpa_utils.laser import antenna_injection as ai
    s0, s1 = _pair(antenna=True, extras=True)
    for sim in (s0, s1):
        sim.checkpoints.append(_Writer())
    blocks = []
    series = ai.LaserAntenna.compute_series

    def record(self, t0, n_steps, dz, **kw):
        blocks.append((kw["it0"], n_steps))
        return series(self, t0, n_steps, dz, **kw)
    ai.LaserAntenna.compute_series = record
    try:
        for n in LAB_CALLS:
            s0.step(n, show_progress=False)
            s1.step(n)
    finally:
        ai.LaserAntenna.compute_series = series
    return jax_state_to_numpy(s0.state), s1, blocks


def test_antenna_mirror_external_run_matches_fbpic(lab_runs):
    ref, s1, blocks = lab_runs
    assert s1._multi_step is not None       # the chunk runner ran it
    assert blocks == [(0, 5), (5, 5), (10, 5)]
    st = s1.state
    for n in SPECT:
        _close(ref["spect"][n], getattr(st.spect, n).numpy(), n, 1e-8)
    for n in INTERP:
        _close(ref["interp"][n], getattr(st.interp, n).numpy(), n, 1e-8)
    # the mirror's cells are zero (to the transforms' roundoff)
    z = s1.grid_z()
    inside = (z >= Z_MIRROR) & (z < Z_MIRROR + 2 * s1.config.dz)
    Er1 = np.abs(s1.get_interp_field("Er", 1))
    assert inside.any()
    assert Er1[inside].max() <= 1e-12 * Er1.max(), \
        Er1[inside].max() / Er1.max()


def test_ring_run_matches_fbpic_multi_step(lab_runs):
    ref, s1, _ = lab_runs
    st = s1.state
    assert st.iteration == ref["iteration"] == sum(LAB_CALLS)
    for n in ("time", "zmin", "mw_zref"):
        assert float(getattr(st, n)) == ref[n], n
    assert int(st.ring_overwrite) == ref["ring_overwrite"]
    sp_ref, sp = ref["species"][0], st.species[0]
    assert sp.next_free == sp_ref["next_free"]
    assert float(sp.inj_z_end) == sp_ref["inj_z_end"]
    np.testing.assert_array_equal(sp_ref["w"] != 0, sp.w.numpy() != 0)
    assert (sp.w != 0).sum() > 0
    for n in PARTICLE:
        _close(sp_ref[n], getattr(sp, n).numpy(), n, 1e-12)


# ---------------------------------------------------------------------
# (d) the runner's device scalars against the host's numbers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_scalars_equal_host_scalars(dtype):
    """Each step twice from one state: with the host's numbers and with
    the StepScalars of the runner's own tables (its plan, upload and row
    picking); the same bits.  Then the chunk runner against the eager
    loop over the same steps."""
    from fbpic_tpu_torch.core.graph import MultiStep, state_tensors
    from fbpic_tpu_torch.core.step import make_step, prepare
    sim = _sim("fbpic_tpu_torch", dtype=dtype, antenna=True, extras=True)
    options = sim.build_options()
    step = make_step(sim.config, sim.species_configs, options)
    runner = MultiStep(sim.config, sim.species_configs, options)
    st = prepare(sim.config, options, sim.species_configs, sim.state,
                 sim.aux)
    n = 9
    series, _ = sim._antenna_block(n, 0, [])
    args = (sim.aux, tuple(sim._injector_auxes), sim.column_angles,
            sim.generator)
    runner._ensure_static(st, sim.aux, series)
    plans, rows, irows = runner._plan(st, n, series)
    runner._upload(rows, irows)
    kw = dict(antenna_series=runner._load_series(series))
    runner._index.zero_()
    on = set()
    for k in range(n):
        gen = sim.generator.get_state()
        host = step(st, *args, **kw)
        sim.generator.set_state(gen)
        scalars = runner._scalars(*runner._row())
        on.add(float(scalars.antennas[0][5]))
        dev = step(st, *args, scalars=scalars, **kw)
        for i, (a, b) in enumerate(zip(state_tensors(host),
                                       state_tensors(dev))):
            assert torch.equal(a, b), (k, i)
        runner._index.add_(1)
        st = host
    assert on == {1.0}                   # the antenna emits every step
    assert sum(p.exchange for p in plans) >= 2
    chunked = _sim("fbpic_tpu_torch", dtype=dtype, antenna=True,
                   extras=True)
    eager = _sim("fbpic_tpu_torch", dtype=dtype, antenna=True, extras=True)
    chunked.step(n)
    assert chunked._multi_step is not None
    _eager_loop(eager, n)
    _assert_states_equal(chunked.state, eager.state)


def _eager_loop(sim, n):
    """Simulation.step(n) through the eager loop (``_run_eager``)."""
    from fbpic_tpu_torch.core.step import prepare
    options = sim.build_options()
    sim.state = prepare(sim.config, options, sim.species_configs, sim.state,
                        sim.aux)
    sim._run_eager(n, options, [], [], None)
    sim._consume_overflow_counters()


def test_antenna_device_form_equals_host_form():
    """add_antenna_current_device against add_antenna_current at each
    case of antenna_cells: inside the box, at both edges, outside it."""
    from fbpic_tpu_torch.lpa_utils.laser.antenna_injection import (
        add_antenna_current, add_antenna_current_device, antenna_cells)
    sim = _sim("fbpic_tpu_torch", antenna=True)
    ant = sim.laser_antennas[0]
    dz, Nz, n = sim.config.dz, 24, 12
    series = ant.compute_series(0., n, dz, device="cpu", dtype=torch.float64)
    rng = np.random.RandomState(3)
    grids = [torch.as_tensor(rng.randn(NM, Nz, NR)
                             + 1j * rng.randn(NM, Nz, NR)) for _ in range(2)]
    z = series.z_pos
    cases = [(3, z[3] - 10.3 * dz), (5, z[5] - 1.2 * dz),
             (6, z[6] - (Nz - 0.6) * dz), (8, z[8] + 3 * dz),
             (n + 4, z[-1] - 6.7 * dz)]
    states = set()
    for it, zmin in cases:
        zmin = np.float64(zmin)
        host = add_antenna_current(*grids, series, it, zmin, dz, Nz)
        i, iz0c, iz1c, s0, s1, on = antenna_cells(series, it, zmin, dz, Nz)
        states.add(on)
        cells = tuple(torch.tensor(v) for v in (i, iz0c, iz1c)) + tuple(
            torch.tensor(float(v), dtype=torch.float64) for v in (s0, s1, on))
        dev = add_antenna_current_device(*grids, series, cells)
        for a, b in zip(host, dev):
            assert torch.equal(a, b), it
    assert states == {True, False}


# ---------------------------------------------------------------------
# (e) what keeps the eager loop
# ---------------------------------------------------------------------

def _blockers(sim):
    from fbpic_tpu_torch.core.graph import graph_blockers
    return graph_blockers(sim, sim.build_options())


def _base(**kw):
    from fbpic_tpu_torch import Simulation
    sim = Simulation(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
                     dtype=torch.float64, **dict(SIM_KW, **kw))
    return sim


def _with_species(sim, **kw):
    sim.add_new_species(**dict(RING_KW, **kw))
    return sim


def _resident():
    sim = _base()
    sim.use_fused_deposit = True
    return _with_species(sim, sort_K=256)


def _btd_sim():
    sim = _sim("fbpic_tpu_torch", frame="galilean")
    sim.diags.append(_btd("fbpic_tpu_torch", sim))
    return sim


def _ionizable():
    sim = _base()
    elec = _with_species(sim)
    ions = sim.add_new_species(q=e, m=1836 * m_e, n=1.e24, p_nz=1, p_nr=1,
                               p_nt=4, p_zmin=0., p_zmax=1.e-6,
                               p_rmax=5.e-6)
    ions.make_ionizable("N", target_species=sim.ptcl[0], level_start=5)
    return elec


def _compton():
    sim = _with_species(_base())
    photons = sim.add_new_species(q=0., m=0.)
    sim.ptcl[0].activate_compton(
        photons, laser_energy=1., laser_wavelength=0.8e-6,
        laser_waist=5.e-6, laser_ctau=3.e-6, laser_initial_z0=0.)
    return sim


def _ballistic():
    from fbpic_tpu_torch.lpa_utils.bunch import add_particle_bunch
    sim = _with_species(_base())
    add_particle_bunch(sim, -e, m_e, 100., 1.e24, -2.e-6, -1.e-6, 0., 2.e-6,
                       initialize_self_field=False, z_injection_plane=0.)
    return sim


CONFIGS = {
    "resident": (_resident, []),
    "ring": (lambda: _with_species(_base()), []),
    "antenna, mirror, external field": (
        lambda: _sim("fbpic_tpu_torch", antenna=True, extras=True), []),
    "boosted ring + BTD": (_btd_sim, []),
    "cubic ring": (lambda: _with_species(_base(particle_shape="cubic")),
                   []),
    "cross-deposition": (lambda: _with_species(
        _base(current_correction="cross-deposition")), []),
    "ionization": (_ionizable, []),
    "Compton": (_compton, []),
    "ballistic": (_ballistic, []),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_blockers(name):
    build, want = CONFIGS[name]
    assert _blockers(build()) == (want, [])

"""The chunk runner (core/graph.py) with ionization, Compton scattering
and a ballistic species.  CPU, float64, at tests/test_torch_multistep.py's
scale (internal Nz 64, Nr 16, Nm 2; open z, a moving window, exchange
period 4).

- (a) One run holds all three: resident helium ions ionized by an a0 =
  0.5 laser with per-level routing (level 0's electrons into a tracked
  ring, level 1's into a tracked resident species), and a gamma = 100
  Gaussian bunch (a ring) that crosses its injection plane inside the
  chunk and scatters Compton photons into a photon ring.  fbpic_tpu's
  ``Simulation.step(12)`` (its ``make_multi_step``: one jitted program
  a chunk) against the port's, which runs the chunk runner (its graphed
  steps' body on CPU tensors), with fbpic_tpu's draws and injection
  angles fed to the port (tests/test_torch_ionization.py's
  ``jax_process_draws``): the 12 steps cross three exchange steps and a
  window shift every step.  Particles to 1e-12 of their vector's scale
  (the photons to 1e-9: tests/test_torch_compton.py's PHOTON_TOL),
  fields to 1e-8, levels, ids, cursors and counters exactly.
- (b) The chunk runner's new table columns (the processes' time t +
  dt/2 and each ballistic species' plane) against the host's values,
  atol 0, beside a resident plasma, the bunch's plane made to move at
  -c/2 (as a boosted run's plane moves); each step with the host's
  numbers against the same step with the runner's StepScalars, bit for
  bit, float32 and float64.
- (c) ``graph_blockers``: none for these runs; on CUDA only, a process
  draw source other than a ``GeneratorDraws`` of the simulation's
  generator.
- (d) A new draw source or generator: a new chunk runner, the old one
  released.
- (e) A planted banded re-sort overflow in an ionizing chunk: the chunk
  rolled back (the generator's state with it) equals the eager run bit
  for bit, the draws included.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from fbpic_tpu.constants import c, e, m_e, m_p  # noqa: E402
from test_torch_ionization import (  # noqa: E402
    INTERP, VECTORS, close, jax_column_angles, jax_process_draws,
    jax_state_to_numpy)

NZ_PHYS, NR, NM = 24, 16, 2
ZMAX, ZMIN, RMAX = 2.e-6, -4.e-6, 10.e-6
DT = (ZMAX - ZMIN) / NZ_PHYS / c
SIM_KW = dict(zmin=ZMIN, n_order=16, n_guard=8, n_damp={"z": 8, "r": 32},
              boundaries={"z": "open", "r": "reflective"},
              exchange_period=4, random_seed=0, verbose_level=0)
PLASMA = dict(p_zmin=-3.e-6, p_zmax=100.e-6, p_rmin=0., p_rmax=9.e-6,
              continuous_injection=True, sort_K=256)
LASER_KW = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=-1.e-6)
# The bunch: gamma 100, centred 1.5 um behind its injection plane z = 0,
# sig_z 0.25 um (it crosses the plane in steps 2-10: 0.25 um a step); its
# emittance gives it transverse momentum, without which the rest-frame
# direction of the incoming photon is ill-conditioned
# (tests/test_torch_compton.py's BATH_BEAM)
BUNCH = dict(sig_r=1.e-6, sig_z=0.25e-6, n_emit=1.e-6, gamma0=100.,
             sig_gamma=1., n_physical_particles=1.e8, n_macroparticles=400,
             zf=-1.5e-6)
PLANE = 0.
# A uniform photon bath (waist and length far beyond the box) of ~0.03
# scatterings a step per electron
BATH = dict(laser_energy=4.e6, laser_wavelength=0.8e-6, laser_waist=1.e-3,
            laser_ctau=1.e-2, laser_initial_z0=0.)
N_STEPS = 12
PHOTON_TOL = 1e-9
# fbpic_tpu's window shift rolls a banded resident species' stored rows
# but not its ionization levels (its core/step.py:1688-1697), so there
# the levels leave their particles at every shift; the port rolls them
# with the particles.  The comparison with fbpic_tpu therefore sorts the
# ions afresh every step (no roll: the packages agree); the banded ions
# run in the port-only tests below
IONS_RESORT = "full"
# Species of (a): 0 helium ions (resident), 1 level-0 electrons (a
# tracked ring), 2 level-1 electrons (tracked, resident), 3 the bunch (a
# ballistic, Compton-active ring), 4 its photons (a ring)
GROUPS = {"ionization": (0, 1, 2), "ballistic": (3,), "compton": (3, 4)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads (the suite runs several test processes side
    by side) for the whole module: pytest sets the shared runs up before
    any function-scoped fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _build(pkg, dtype=torch.float64, parts=("ionization", "bunch"),
           ions_resort="banded"):
    """The run of (a) in fbpic_tpu ("fbpic_tpu") or the port; parts:
    which of a resident plasma ("plasma"), the ionizer and its targets
    ("ionization") and the bunch with its photons ("bunch") to add, in
    that order; ions_resort: the resident ions' re-sort ("full": sorted
    afresh every step, so the window's shift moves no stored row of
    theirs; IONS_RESORT says why)."""
    import importlib
    Simulation = importlib.import_module(pkg).Simulation
    laser = importlib.import_module(f"{pkg}.lpa_utils.laser")
    bunch = importlib.import_module(f"{pkg}.lpa_utils.bunch")
    kw = dict(SIM_KW)
    if pkg != "fbpic_tpu":
        kw.update(device="cpu", dtype=dtype)
    sim = Simulation(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **kw)
    sim.use_fused_deposit = True
    if "plasma" in parts:
        sim.add_new_species(q=-e, m=m_e, n=5.e24, p_nz=1, p_nr=2, p_nt=4,
                            **PLASMA)
    if "ionization" in parts:
        ions = sim.add_new_species(q=e, m=4 * m_p, n=1.e24, p_nz=1, p_nr=1,
                                   p_nt=4, **PLASMA)
        ring = sim.add_new_species(q=-e, m=m_e)
        resident = sim.add_new_species(q=-e, m=m_e, sort_K=256)
        ions.make_ionizable("He", {0: ring, 1: resident}, level_start=0)
        sim.species_configs[ions._index] = dataclasses.replace(
            sim.species_configs[ions._index], resort=ions_resort)
        ring.track()
        resident.track()
    if "bunch" in parts:
        b = bunch.add_particle_bunch_gaussian(
            sim, -e, m_e, z_injection_plane=PLANE,
            initialize_self_field=False, **BUNCH)
        photons = sim.add_new_species(q=0., m=0.)
        b.activate_compton(photons, **BATH)
    laser.add_laser_pulse(sim, laser.GaussianLaser(**LASER_KW))
    sim.set_moving_window(v=c)
    return sim


def _behind_plane(sp):
    z, w = (np.asarray(a) for a in (sp.z, sp.w))
    return int(((z <= PLANE) & (w != 0)).sum())


@pytest.fixture(scope="module")
def runs():
    """fbpic_tpu's step(N_STEPS) and the port's on (a)'s run, from the
    same seeds, fbpic_tpu's draws and angles fed to the port."""
    s0, s1 = (_build(pkg, ions_resort=IONS_RESORT)
              for pkg in ("fbpic_tpu", "fbpic_tpu_torch"))
    seed = int(s0.state.seed)
    s1.column_angles = jax_column_angles(seed)
    s1.process_draws = jax_process_draws(seed)
    assert [sc.resident for sc in s1.species_configs] == \
        [True, False, True, False, False]
    assert s1.species_configs[0].ionizer.per_level_targets == (1, 2)
    assert s1.species_configs[3].ballistic_z0 == PLANE
    bunches = (s0.state.species[3], s1.state.species[3])
    before = [_behind_plane(sp) for sp in bunches]
    n_bunch = [int((np.asarray(sp.w) != 0).sum()) for sp in bunches]
    s0.step(N_STEPS)
    s1.step(N_STEPS)
    assert s1._multi_step is not None       # the chunk runner ran it
    return dict(ref=jax_state_to_numpy(s0.state), sim=s1,
                behind_before=before, n_bunch=n_bunch)


def test_fields_and_counters_match_fbpic(runs):
    ref, st = runs["ref"], runs["sim"].state
    assert st.iteration == ref["iteration"] == N_STEPS
    for n in ("time", "zmin", "mw_zref"):
        assert float(getattr(st, n)) == ref[n], n
    assert int(st.sort_overflow) == ref["sort_overflow"] == 0
    assert int(st.ring_overwrite) == ref["ring_overwrite"] == 0
    for n in ref["spect"]:
        close(ref["spect"][n], getattr(st.spect, n).numpy(), n, 1e-8)
    for n in INTERP:
        close(ref["interp"][n], getattr(st.interp, n).numpy(), n, 1e-8)


def _species_match(sp_ref, sp, i, tol):
    """tests/test_torch_ionization.py's per-species check: the live
    slots, each vector to tol of its scale, levels, ids and cursors
    exactly."""
    from fbpic_tpu_torch.utils.carry import join_words
    live = sp_ref["w"] != 0
    np.testing.assert_array_equal(live, sp.w.numpy() != 0)
    for group in VECTORS:
        scale = max(np.abs(sp_ref[n][live]).max(initial=0) for n in group)
        for n in group:
            close(sp_ref[n][live], getattr(sp, n).numpy()[live],
                  f"species {i} {n}", tol, scale)
    if sp_ref["ionization_level"] is not None:
        np.testing.assert_array_equal(sp_ref["ionization_level"][live],
                                      sp.ionization_level.numpy()[live])
    if sp_ref["ids"] is not None:
        np.testing.assert_array_equal(
            join_words(sp_ref["ids"], sp_ref["ids_hi"])[live].astype(
                np.int64), sp.ids.numpy()[live])
        assert int(sp.next_id) == int(join_words(sp_ref["next_id"],
                                                 sp_ref["next_id_hi"]))
    if sp_ref["next_free"] is not None:
        assert int(sp.next_free) == sp_ref["next_free"], i
    return int(live.sum())


@pytest.mark.parametrize("group", list(GROUPS))
def test_species_match_fbpic(runs, group):
    ref, sim = runs["ref"], runs["sim"]
    st = sim.state
    live = {i: _species_match(ref["species"][i], st.species[i], i,
                              PHOTON_TOL if i == 4 else 1e-12)
            for i in GROUPS[group]}
    if group == "ionization":
        # both levels' electrons created, each in its own species
        lev = st.species[0].ionization_level[st.species[0].w != 0]
        assert live[1] == int((lev >= 1).sum()) > 50
        assert live[2] == int((lev >= 2).sum()) > 50
    elif group == "compton":
        assert live[4] > 20                     # photons created
    else:
        # every bunch particle behind the plane at the start, none after
        assert runs["behind_before"] == runs["n_bunch"] == [live[3]] * 2
        assert _behind_plane(st.species[3]) == 0
        assert _behind_plane(SimpleNamespace(**{
            n: ref["species"][3][n] for n in ("z", "w")})) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_table_columns_equal_host_scalars(dtype):
    """The runner's rows against the host's process time and planes
    (atol 0, in the working dtype), and each step with the host's
    numbers against the same step with the runner's StepScalars."""
    from fbpic_tpu_torch.core.graph import (MultiStep, _N_BASE, _TIME_MID,
                                            state_tensors)
    from fbpic_tpu_torch.core.step import (
        ballistic_plane, ensure_counters, process_time, prepare)
    sim = _build("fbpic_tpu_torch", dtype, parts=("plasma", "bunch"))
    sim.species_configs[1] = sc = dataclasses.replace(
        sim.species_configs[1], ballistic_v=-0.5 * c)
    options = sim.build_options()
    runner = MultiStep(sim.config, sim.species_configs, options)
    st = ensure_counters(prepare(sim.config, options, sim.species_configs,
                                 sim.state, sim.aux))
    runner._ensure_static(st, sim.aux, ())
    n = 9
    plans, rows, irows = runner._plan(st, n, ())
    runner._upload(rows, irows)
    kw = dict(comp_auxes=tuple(sim._compton_auxes), draws=sim.process_draws)
    args = (sim.aux, tuple(sim._injector_auxes), sim.column_angles,
            sim.generator)
    replayed = 0
    for k, plan in enumerate(plans):
        runner._index.fill_(k)
        row, irow = runner._row()
        want = [process_time(st.time, sim.dt),
                ballistic_plane(sc, st.time, sim.dt)]
        got = [row[_TIME_MID], row[_N_BASE]]
        for w, g in zip(want, got):
            assert g.dtype == dtype
            assert float(g) == float(torch.tensor(float(w), dtype=dtype))
        gen = sim.generator.get_state()
        host = runner.step(st, *args, **kw)
        if plan.exchange:
            st = host
            continue
        sim.generator.set_state(gen)
        dev = runner.step(st, *args, scalars=runner._scalars(row, irow),
                          redo_flag=torch.zeros((), dtype=torch.int64),
                          **kw)
        for i, (a, b) in enumerate(zip(state_tensors(host),
                                       state_tensors(dev))):
            assert torch.equal(a, b), (k, i)
        replayed += 1
        st = host
    assert replayed >= 6
    # the plane moved, and photons were scattered in the steps compared
    assert len({r[_N_BASE] for r in rows}) == n
    assert int((st.species[2].w != 0).sum()) > 0


def test_graph_blockers_of_process_runs():
    from fbpic_tpu_torch.core.graph import graph_blockers
    from fbpic_tpu_torch.particles.draws import GeneratorDraws
    sim = _build("fbpic_tpu_torch")
    options = sim.build_options()
    assert isinstance(sim.process_draws, GeneratorDraws)
    assert graph_blockers(sim, options) == ([], [])

    def user_draws(name, iteration, species_index, shape, dtype):
        return torch.rand(shape, dtype=dtype)
    sim.process_draws = user_draws
    assert graph_blockers(sim, options) == ([], [])    # on the CPU
    on_card = SimpleNamespace(species_configs=sim.species_configs,
                              device=torch.device("cuda"),
                              generator=sim.generator,
                              process_draws=user_draws)
    blocked = ["a process draw source other than the simulation's "
               "GeneratorDraws"]
    assert graph_blockers(on_card, options) == (blocked, [])
    # a GeneratorDraws of another generator, which the graphs would not
    # advance
    on_card.process_draws = GeneratorDraws(torch.Generator())
    assert graph_blockers(on_card, options) == (blocked, [])

    class Subclass(GeneratorDraws):
        pass
    for source in (GeneratorDraws, Subclass):
        on_card.process_draws = source(sim.generator)
        assert graph_blockers(on_card, options) == ([], [])
    # without a process, the draw source is never called
    plain = dataclasses.replace
    on_card.species_configs = [plain(sc, ionizer=None, compton=None)
                               for sc in sim.species_configs]
    on_card.process_draws = lambda *a: None
    assert graph_blockers(on_card, options) == ([], [])


def test_new_draw_source_rebuilds_the_runner():
    """The runner's graphs call the draw source and register the
    generator at their capture: replacing either builds a new runner,
    the old one released (its graphs and static buffers dropped)."""
    from fbpic_tpu_torch.particles.draws import GeneratorDraws
    sim = _build("fbpic_tpu_torch", parts=("plasma", "ionization"))
    sim.step(1)
    first = sim._multi_step
    sim.step(1)
    assert sim._multi_step is first
    sim.process_draws = GeneratorDraws(sim.generator)
    sim.step(1)
    second = sim._multi_step
    assert second is not first
    assert first.graphs == {} and first._static is None
    sim.generator = torch.Generator()
    sim.process_draws = GeneratorDraws(sim.generator)
    sim.step(1)
    assert sim._multi_step is not second and second._static is None


def _eager_steps(sim, n):
    """Simulation.step(n) through the eager loop: the preparation, the
    eager step n times (the processes' auxiliaries and draws included),
    the overflow read."""
    from fbpic_tpu_torch.core.step import make_prepare
    options = sim.build_options()
    sim.state = make_prepare(sim.config, sim.species_configs, options)(
        sim.state, sim.aux)
    sim._run_eager(n, options, [], [], None)
    sim._consume_overflow_counters()


def test_planted_rollback_in_an_ionizing_chunk_equals_the_eager_run():
    from fbpic_tpu_torch.core.graph import state_tensors
    chunked, eager = (_build("fbpic_tpu_torch",
                             parts=("plasma", "ionization"))
                      for _ in range(2))
    chunked.step(5)
    _eager_steps(eager, 5)
    assert chunked.state.iteration % chunked.exchange_period != 0
    for sim in (chunked, eager):
        sp, K = sim.state.species[0], sim.species_configs[0].sort_K
        Nz, dz = sim.config.Nz, sim.config.dz
        live = (sp.w != 0).reshape(Nz, K)
        counts = live.sum(1)
        row = int(torch.argmax(counts[:-2] + counts[1:-1]
                               + counts[2:])) + 1
        assert int(counts[row - 1:row + 2].sum()) > K
        z = sp.z.clone().reshape(Nz, K)
        z[row - 1] = torch.where(live[row - 1], z[row - 1] + dz,
                                 z[row - 1])
        z[row + 1] = torch.where(live[row + 1], z[row + 1] - dz,
                                 z[row + 1])
        sim.state.species[0] = sp.replace(z=z.reshape(-1))
    with pytest.warns(RuntimeWarning, match="sort_K auto-bumped"):
        chunked.step(3)
    with pytest.warns(RuntimeWarning, match="sort_K auto-bumped"):
        _eager_steps(eager, 3)
    assert chunked.overflow_totals["rollbacks"] == 1
    a, b = chunked.state, eager.state
    assert (a.iteration, float(a.time), float(a.zmin)) == \
        (b.iteration, float(b.time), float(b.zmin))
    for i, (x, y) in enumerate(zip(state_tensors(a), state_tensors(b))):
        assert torch.equal(x, y), i
    assert torch.equal(chunked.generator.get_state(),
                       eager.generator.get_state())
    assert int((a.species[2].w != 0).sum()) > 0     # electrons created

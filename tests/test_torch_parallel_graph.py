"""The slabs' chunk runner (parallel/domain.py ``SlabMultiStep``) on the
CPU, where the slab threads call the body that a CUDA graph replays on
the card: held bit for bit against the eager slab loop (``run.eager``),
on examples/multichip_lwfa_script.py at its smoke size
(``FBPIC_TPU_EXAMPLE_SMOKE``: Nz 160, Nr 12, Nm 2, 1x1x4 per cell,
n_order 8; a0 = 4, open z, moving window), float32 (the card's resident
banded layout), on 2 and 4 slabs:

- the laser emitted by an antenna, a back-transformed field diagnostic;
  14 steps (exchange steps at 0, 6 and 12, every step a window shift):
  every tensor of every slab, the host values, the generators' states,
  the live counts and the counters equal; the back-transformed field
  diagnostic's captured rows (``decomposed_capture``, written by slab 0
  into the runner's buffers) equal; each step's antenna plane deposited
  by exactly one slab (each slab's table);
- the charge density record (``get_interp_field("rho")``: each slab's
  rho_prev summed over the halo) within 5e-3 of the single card's on
  every row, where each slab's own rho_prev is off by ~1 at the seams;
- a column overflow planted on a slab: the runner's chunk rolls back
  (all slabs) and equals the eager loop, the lost particles counted
  alike;
- ``graph_blockers``: empty on the CPU and for slabs on several cards
  (one graph a card); a process draw source and a host density
  function still named there.
- The migration and the exchange block inside the slab body (their
  bounds and column counts tensors of each slab's table) at 2 and 4
  slabs, bit for bit with the eager slab loop (whose values are the
  host's); a numpy density function keeps them eager in the slab
  threads (``graph_blockers`` names it), bit for bit too.
"""
import dataclasses
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c  # noqa: E402

NZ, ZMAX, ZMIN = 160, 30.e-6, -10.e-6
NR, RMAX, NM = 12, 20.e-6, 2
DT = (ZMAX - ZMIN) / NZ / c
N_STEPS = 14
GAMMA_B = 5.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the slabs are the parallelism (for the whole
    module: pytest sets the shared pairs up before any function-scoped
    fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lwfa(antenna=False, btd_dir=None, **kw):
    """The multichip example at its smoke size on the CPU, float32,
    seeded; with a back-transformed field diagnostic writing into
    ``btd_dir``, or its laser emitted by an antenna."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    sim = Simulation(NZ, ZMAX, NR, RMAX, NM, DT, p_zmin=0., p_zmax=500.e-6,
                     p_rmin=0., p_rmax=18.e-6, p_nz=1, p_nr=1, p_nt=4,
                     n_e=4.e24, zmin=ZMIN, n_order=8,
                     boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device="cpu",
                     dtype=torch.float32, **kw)
    laser = GaussianLaser(a0=4., waist=5.e-6, tau=16.7e-15, z0=-8.e-6)
    if antenna:
        add_laser_pulse(sim, laser, method="antenna", z0_antenna=-2.e-6)
    else:
        add_laser_pulse(sim, laser)
    sim.set_moving_window(v=c)
    if btd_dir is not None:
        beta = np.sqrt(1 - 1 / GAMMA_B**2)
        # snapshot plane i sits ~i * 20 um ahead of the box's start and
        # sweeps back one cell a step: three planes in the box
        sim.diags = [BackTransformedFieldDiagnostic(
            0.0, GAMMA_B * ZMAX, 0.0, GAMMA_B * beta * 20.e-6 / c, 5,
            GAMMA_B, sim=sim, write_dir=btd_dir)]
    return sim


def record_rows(sim):
    """Every chunk of rows the back-transformed diagnostic consumes."""
    rows = []
    diag = sim.diags[0]
    real = diag.process_chunk

    def record(s, caps):
        rows.append([np.array(a) for a in caps])
        return real(s, caps)
    diag.process_chunk = record
    return rows


def pair(n_slabs, build=lwfa, n_steps=N_STEPS, **dist_kw):
    """The runner's run and its eager twin (the eager slab loop), from
    the same seeds, n_steps each; ``exchange_calls`` on each: its
    injections' and migrations' values, tensors of the step's scalars or
    the host's (``ExchangeRecorder``)."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    runs = []
    for eager in (False, True):
        run = distribute_simulation(build(), devices=["cpu"] * n_slabs,
                                    **dist_kw)
        run.eager = eager
        run.rows = record_rows(run.sim) if run.sim.diags else []
        with ExchangeRecorder() as rec:
            if n_steps:
                run.step(n_steps)
        run.exchange_calls = rec.calls
        runs.append(run)
    return runs


class ExchangeRecorder:
    """While it is entered: whether each injection and each migration
    read its values from the step's scalars (tensors) or from the
    host."""

    def __enter__(self):
        from fbpic_tpu_torch.core import step as step_mod
        from fbpic_tpu_torch.parallel import domain
        self.calls = []
        self.real = [(step_mod, "continuous_injection",
                      step_mod.continuous_injection),
                     (domain, "migrate_particles", domain.migrate_particles)]
        inject, migrate = (fn for _, _, fn in self.real)

        def record_inject(sp, inj_cfg, inj_aux, columns, *args, **kwargs):
            self.calls.append(("inject", torch.is_tensor(columns[0])))
            return inject(sp, inj_cfg, inj_aux, columns, *args, **kwargs)

        def record_migrate(*args, bounds=None, **kwargs):
            self.calls.append(("migrate", bounds is not None))
            return migrate(*args, bounds=bounds, **kwargs)
        step_mod.continuous_injection = record_inject
        domain.migrate_particles = record_migrate
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.real:
            setattr(module, name, fn)


def assert_equal_runs(a, b):
    """Every tensor of every slab, the host values, the generators and
    the counters equal."""
    from fbpic_tpu_torch.core.graph import state_tensors
    assert len(a.states) == len(b.states)
    for r, (sa, sb) in enumerate(zip(a.states, b.states)):
        ta, tb = state_tensors(sa), state_tensors(sb)
        assert len(ta) == len(tb)
        for i, (x, y) in enumerate(zip(ta, tb)):
            assert torch.equal(x, y), (r, i)
        for name in ("time", "zmin", "mw_zref", "iteration"):
            assert getattr(sa, name) == getattr(sb, name), (r, name)
        assert float(sa.species[0].inj_z_end) == float(
            sb.species[0].inj_z_end)
    for ga, gb in zip(a._generators, b._generators):
        assert torch.equal(ga.get_state(), gb.get_state())
    assert a.live_counts == b.live_counts
    assert a.iteration == b.iteration


_PAIRS = {}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """The 2- and 4-slab pairs with the antenna and the back-transformed
    diagnostic, built and run once for the module's cases."""
    def get(n_slabs):
        if n_slabs not in _PAIRS:
            path = str(tmp_path_factory.mktemp(f"btd{n_slabs}"))
            _PAIRS[n_slabs] = pair(n_slabs, lambda: lwfa(antenna=True,
                                                         btd_dir=path))
        return _PAIRS[n_slabs]
    yield get
    _PAIRS.clear()


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_runner_matches_eager_slab_loop(pairs, n_slabs):
    graphed, eager = pairs(n_slabs)
    assert graphed._runner is not None and not graphed.eager
    assert graphed.exchange_period == 6
    assert graphed.iteration == N_STEPS
    # the window moved every step, the exchange block ran three times
    assert float(graphed.states[0].zmin) > float(graphed.sim.state.zmin)
    assert graphed.config_local.Nz * graphed.sim.species_configs[
        0].sort_K == graphed.states[0].species[0].capacity
    assert_equal_runs(graphed, eager)
    live = graphed.live_counts[0]
    assert len(live) == n_slabs and max(live) > 0
    assert graphed.overflow_totals == eager.overflow_totals == {
        "migration_overflow": 0, "sort_overflow": 0, "ring_overwrite": 0}


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_back_transformed_rows_match_eager_slab_loop(pairs, n_slabs):
    graphed, eager = pairs(n_slabs)
    # the write at iteration 0 (the gathered state's planes), then the
    # chunk's rows
    assert len(graphed.rows) == len(eager.rows) == 2
    valid, z_lab, slices = graphed.rows[1]
    assert valid.shape == (N_STEPS, 5)
    assert slices.shape[0] == N_STEPS and np.abs(slices).max() > 0
    assert 0 < int(valid.sum()) < valid.size
    for rows_a, rows_b in zip(graphed.rows, eager.rows):
        for x, y in zip(rows_a, rows_b):
            np.testing.assert_array_equal(x, y)


def test_rho_record_matches_single_card_on_every_row(pairs):
    from fbpic_tpu_torch.fields import transform as tr
    graphed, _ = pairs(4)
    single = lwfa(antenna=True)
    single.step(N_STEPS)
    ref = tr.spect2interp_scal(single.aux.mats,
                               single.state.spect.rho_prev).numpy()[0]
    scale = np.abs(ref).max()
    rho = graphed.get_interp_field("rho", 0)
    assert rho.shape == ref.shape
    assert np.abs(rho - ref).max() / scale < 5e-3
    # each slab's own rho_prev misses its neighbours' charge at the seams
    raw = graphed.get_interp_field("rho_prev", 0)
    assert np.abs(raw - ref).max() / scale > 0.1


def test_planted_overflow_rolls_back_every_slab():
    """sort_K 128 (44 particles a column here): the live particles of
    the rows around a slab's fullest three moved into the middle column
    overflow it; the runner's chunk sees the slab's redo flag, runs
    again through the eager slab loop and equals it."""
    graphed, eager = pair(2, lambda: lwfa(sort_K=128), n_steps=7,
                          on_migration_overflow="warn")
    for run in (graphed, eager):
        cfg, K = run.config_local, run.sim.species_configs[0].sort_K
        st = run.states[1]
        sp = st.species[0]
        live = (sp.w != 0).reshape(cfg.Nz, K)
        counts = live.sum(1)
        row = int(torch.argmax(counts[:-2] + counts[1:-1] + counts[2:])) + 1
        assert int(counts[row - 1:row + 2].sum()) > K
        z = sp.z.clone().reshape(cfg.Nz, K)
        z[row - 1] = torch.where(live[row - 1], z[row - 1] + cfg.dz,
                                 z[row - 1])
        z[row + 1] = torch.where(live[row + 1], z[row + 1] - cfg.dz,
                                 z[row + 1])
        run.states[1] = dataclasses.replace(
            st, species=[sp.replace(z=z.reshape(-1))])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        graphed.step(3)
        eager.step(3)
    assert graphed.overflow_totals["rollbacks"] == 1
    assert "rollbacks" not in eager.overflow_totals
    assert graphed.overflow_totals["sort_overflow"] == \
        eager.overflow_totals["sort_overflow"] > 0
    assert_equal_runs(graphed, eager)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_antenna_plane_on_one_slab_a_step(pairs, n_slabs):
    """Each slab's table row puts the antenna's slice on its grid only
    where the slab owns the plane: exactly one slab a step."""
    from fbpic_tpu_torch.core.graph import _N_BASE
    graphed, _ = pairs(n_slabs)
    assert len(graphed.sim.laser_antennas) == 1
    on = torch.stack([b._table[:N_STEPS, _N_BASE + 2]
                      for b in graphed.runner.bufs])
    assert on.sum(0).tolist() == [1.0] * N_STEPS
    assert np.abs(graphed.get_interp_field("Ez", 1)).max() > 0


def test_graph_blockers_name_slabs_on_several_cards():
    """Slabs on several cards take the chunk runner (one graph a card):
    no blocker names them, on two cards or on four; the other reasons
    still block there -- a process draw source other than the
    simulation's GeneratorDraws keeps the eager slab loop, a host
    density function keeps the exchange block eager."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    from fbpic_tpu_torch.parallel.api import DistributedRun
    sim = lwfa()
    run = distribute_simulation(sim, devices=["cpu"] * 2)
    assert run.graph_blockers == ([], [])

    def blockers(sim, n_cards, n_slabs=4):
        return DistributedRun.graph_blockers.fget(types.SimpleNamespace(
            devices=[torch.device("cuda", r * n_cards // n_slabs)
                     for r in range(n_slabs)],
            sim=sim, options=run.options))
    for n_cards in (1, 2, 4):
        assert blockers(sim, n_cards) == ([], [])
    ionizing = types.SimpleNamespace(
        process_draws=lambda *args, **kw: None,
        species_configs=[types.SimpleNamespace(ionizer=object(),
                                               compton=None)],
        device=torch.device("cuda:0"), column_angles=None)
    loop = blockers(ionizing, 4).loop
    assert len(loop) == 1 and "process draw source" in loop[0]

    def ramp(z, r):
        return np.where(z > 2.e-6, 1., 0.5)
    host = lwfa(dens_func=ramp)
    on_host = distribute_simulation(host, devices=["cpu"] * 2)
    for n_cards in (2, 4):
        b = DistributedRun.graph_blockers.fget(types.SimpleNamespace(
            devices=[torch.device("cuda", r % n_cards) for r in range(4)],
            sim=host, options=on_host.options))
        assert b.loop == [] and len(b.exchange) == 1
        assert "density function" in b.exchange[0]


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_exchange_inside_the_slab_body(pairs, n_slabs):
    graphed, eager = pairs(n_slabs)
    assert graphed.graph_blockers == ([], [])
    # exchange steps 0, 6 and 12: every slab migrates, injects once
    n = 3 * n_slabs
    assert sorted(graphed.exchange_calls) == [("inject", True)] * n \
        + [("migrate", True)] * n
    assert sorted(eager.exchange_calls) == [("inject", False)] * n \
        + [("migrate", False)] * n
    assert_equal_runs(graphed, eager)


def test_host_density_keeps_the_slab_exchange_eager():
    def ramp(z, r):
        return np.where(z > 2.e-6, 1., 0.5)
    graphed, eager = pair(2, lambda: lwfa(dens_func=ramp))
    blockers = graphed.graph_blockers
    assert blockers.loop == [] and len(blockers.exchange) == 1
    assert "density function" in blockers.exchange[0]
    calls = graphed.exchange_calls
    assert calls == eager.exchange_calls and ("inject", False) in calls \
        and ("inject", True) not in calls
    assert_equal_runs(graphed, eager)

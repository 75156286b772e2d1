"""The chunk runner (core/graph.py, ``make_multi_step``) on the CPU.

- fbpic_tpu's ``Simulation.step(20)`` (its ``make_multi_step``: one
  jitted ``lax.fori_loop`` a chunk) against the port's, which runs the
  chunk runner (on CPU tensors it calls the graphed step's body instead
  of replaying it), over 20 steps that cross five exchange steps, with
  fbpic_tpu's injection angles, float64: tests/test_torch_step.py's
  tolerances (particles 1e-12 and fields 1e-8 of their scale).
- The step with host scalars against the step with StepScalars (0-d
  tensors of the working dtype), atol 0, float32 and float64, in the
  lab frame and in a Galilean chunk whose window shift n_move changes
  from step to step; and the chunk runner against the eager step loop
  over the same steps, atol 0.
- A planted banded re-sort overflow (the particles of two neighbour
  rows moved into the column between them, beyond sort_K): the runner
  rolls the chunk back and runs it again eagerly, and its result equals
  the eager per-step run's, atol 0.
- Chunks end where a writer's period ends (the writers write at the
  iterations the eager loop writes at), and the launch-count bookkeeping
  of a capture (``utils.kernels.add_launches``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from fbpic_tpu.constants import c, e, m_e  # noqa: E402
from test_torch_step import (  # noqa: E402
    jax_column_angles, jax_state_to_numpy, _close, SPECT, INTERP, PARTICLE)

NZ_PHYS, NR, NM = 24, 16, 2
ZMAX, ZMIN, RMAX = 2.e-6, -4.e-6, 10.e-6
DT = (ZMAX - ZMIN) / NZ_PHYS / c
# n_guard 8, n_damp 8 and n_inject 4 at each end: an internal Nz of 64
SIM_KW = dict(zmin=ZMIN, n_order=16, n_guard=8, n_damp={"z": 8, "r": 32},
              boundaries={"z": "open", "r": "reflective"},
              exchange_period=4, random_seed=0, verbose_level=0)
SPECIES_KW = dict(q=-e, m=m_e, n=5.e24, p_zmin=-3.e-6, p_zmax=100.e-6,
                  p_rmin=0., p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4,
                  continuous_injection=True, sort_K=256)
LASER_KW = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=-1.e-6)
GAMMA = 10.


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port_sim(dtype=torch.float64, frame="lab"):
    """The resident LWFA above (frame "lab"), or a Galilean boosted-frame
    box of the same internal size (gamma 10, the grid flowing at
    -c beta, the window at c: n_move changes from step to step)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    kw = dict(SIM_KW, device="cpu", dtype=dtype)
    laser = {}
    if frame == "galilean":
        kw.update(gamma_boost=GAMMA, v_comoving=-c * np.sqrt(
            1. - 1. / GAMMA**2), use_galilean=True)
        laser = dict(gamma_boost=GAMMA)
    sim = Simulation(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **kw)
    sim.use_fused_deposit = True            # the resident layout in f64
    sim.add_new_species(**SPECIES_KW)
    add_laser_pulse(sim, GaussianLaser(**LASER_KW), **laser)
    sim.set_moving_window(v=c, **laser)
    assert sim.config.Nz == 64 and sim.species_configs[0].resident
    return sim


def _eager_steps(sim, n):
    """What Simulation.step(n) did before the chunk runner: prepare, then
    the eager step n times, then the overflow read."""
    from fbpic_tpu_torch.core.step import make_step, prepare
    options = sim.build_options()
    step = make_step(sim.config, sim.species_configs, options)
    sim.state = prepare(sim.config, options, sim.species_configs, sim.state,
                        sim.aux)
    for _ in range(n):
        sim.state = step(sim.state, sim.aux, tuple(sim._injector_auxes),
                         sim.column_angles, sim.generator)
    sim._consume_overflow_counters()


def _assert_states_equal(a, b):
    from fbpic_tpu_torch.core.graph import state_tensors
    assert (a.iteration, float(a.time), float(a.zmin), float(a.mw_zref)) \
        == (b.iteration, float(b.time), float(b.zmin), float(b.mw_zref))
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), i
    for sa, sb in zip(a.species, b.species):
        assert (sa.next_free, float(sa.inj_z_end)) == \
            (sb.next_free, float(sb.inj_z_end))


def test_chunk_runner_matches_fbpic_multi_step():
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    s0 = S0(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **SIM_KW)
    s0.use_fused_deposit = True
    s0.add_new_species(**SPECIES_KW)
    a0(s0, L0(**LASER_KW))
    s0.set_moving_window(v=c)
    s1 = _port_sim()
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    assert s0.species_configs[0].sort_K == s1.species_configs[0].sort_K
    assert s0.exchange_period == s1.exchange_period == 4
    s0.step(20)
    s1.step(20)
    assert s1._multi_step is not None       # the chunk runner ran it
    ref = jax_state_to_numpy(s0.state)
    st = s1.state
    assert st.iteration == ref["iteration"] == 20
    for n in ("time", "zmin", "mw_zref"):
        assert float(getattr(st, n)) == ref[n], n
    assert int(st.sort_overflow) == ref["sort_overflow"] == 0
    assert int(st.ring_overwrite) == ref["ring_overwrite"]
    for n in SPECT:
        _close(ref["spect"][n], getattr(st.spect, n).numpy(), n, 1e-8)
    for n in INTERP:
        _close(ref["interp"][n], getattr(st.interp, n).numpy(), n, 1e-8)
    sp_ref, sp = ref["species"][0], st.species[0]
    assert sp.next_free == sp_ref["next_free"]
    assert float(sp.inj_z_end) == sp_ref["inj_z_end"]
    np.testing.assert_array_equal(sp_ref["w"] != 0, sp.w.numpy() != 0)
    for n in PARTICLE:
        _close(sp_ref[n], getattr(sp, n).numpy(), n, 1e-12)


@pytest.mark.parametrize("frame", ["lab", "galilean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_scalars_equal_host_scalars(dtype, frame):
    """Each step twice from one state, with the host's numbers and with
    the same values as StepScalars: the same bits; then the chunk runner
    against the eager loop over the same 9 steps."""
    from fbpic_tpu_torch.core.graph import state_tensors
    from fbpic_tpu_torch.core.step import (
        StepScalars, make_step, plan_step, prepare)
    sim = _port_sim(dtype, frame)
    options = sim.build_options()
    step = make_step(sim.config, sim.species_configs, options)
    st = prepare(sim.config, options, sim.species_configs, sim.state,
                 sim.aux)
    moves, exchanges = set(), 0
    for _ in range(5):
        plan = plan_step(sim.config, options, st.zmin, st.zmin, st.mw_zref,
                         st.time, st.iteration)
        moves.add(plan.n_move)
        exchanges += plan.exchange
        row = torch.tensor([float(st.zmin), float(plan.zmin_mid),
                            float(plan.zmin_next), float(st.time),
                            float(st.mw_zref)], dtype=dtype)
        gen = sim.generator.get_state()
        host = step(st, sim.aux, tuple(sim._injector_auxes),
                    sim.column_angles, sim.generator)
        sim.generator.set_state(gen)
        dev = step(st, sim.aux, tuple(sim._injector_auxes),
                   sim.column_angles, sim.generator,
                   scalars=StepScalars(*row.unbind(0)))
        for i, (a, b) in enumerate(zip(state_tensors(host),
                                       state_tensors(dev))):
            assert torch.equal(a, b), i
        st = host
    assert exchanges >= 1
    if frame == "galilean":
        assert len(moves) > 1, moves
    chunked, eager = _port_sim(dtype, frame), _port_sim(dtype, frame)
    chunked.step(9)
    _eager_steps(eager, 9)
    assert chunked._multi_step is not None
    _assert_states_equal(chunked.state, eager.state)


def _plant_column_overflow(sim):
    """Move the live particles of the two rows around a column into it:
    more than sort_K particles then belong to that column, which the
    next banded re-sort counts as overflow."""
    sp, K = sim.state.species[0], sim.species_configs[0].sort_K
    Nz, dz = sim.config.Nz, sim.config.dz
    live = (sp.w != 0).reshape(Nz, K)
    counts = live.sum(1)
    row = int(torch.argmax(counts[:-2] + counts[1:-1] + counts[2:])) + 1
    assert int(counts[row - 1:row + 2].sum()) > K
    z = sp.z.clone().reshape(Nz, K)
    z[row - 1] = torch.where(live[row - 1], z[row - 1] + dz, z[row - 1])
    z[row + 1] = torch.where(live[row + 1], z[row + 1] - dz, z[row + 1])
    sim.state.species[0] = sp.replace(z=z.reshape(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planted_overflow_rolls_back_to_the_eager_run(dtype):
    chunked, eager = _port_sim(dtype), _port_sim(dtype)
    chunked.step(5)
    _eager_steps(eager, 5)
    _assert_states_equal(chunked.state, eager.state)
    assert chunked.state.iteration % chunked.exchange_period != 0
    for sim in (chunked, eager):
        _plant_column_overflow(sim)
    with pytest.warns(RuntimeWarning, match="sort_K auto-bumped"):
        chunked.step(3)
    with pytest.warns(RuntimeWarning, match="sort_K auto-bumped"):
        _eager_steps(eager, 3)
    assert chunked.overflow_totals["rollbacks"] == 1
    assert chunked.overflow_totals["sort_overflow"] \
        == eager.overflow_totals["sort_overflow"] > 0
    _assert_states_equal(chunked.state, eager.state)
    # both bumped sort_K; the next call builds a new chunk runner
    runner = chunked._multi_step
    chunked.step(1)
    assert chunked._multi_step is not runner


class _Recorder:
    def __init__(self, period):
        self.period, self.written = period, []

    def write(self, sim):
        if sim.iteration % self.period == 0:
            self.written.append(sim.iteration)


def test_chunks_end_at_every_writers_period():
    sim = _port_sim()
    writers = [_Recorder(3), _Recorder(5)]
    sim.diags.extend(writers)
    sim.step(20)
    for w in writers:
        assert w.written == [0] + [k for k in range(1, 21)
                                   if k % w.period == 0]
    assert sim._chunk_length(100, writers) == 1     # iteration 20
    sim.step(1)
    assert sim._chunk_length(500, writers) == 3     # 21: next at 24
    assert sim._chunk_length(500, []) == 250


def test_capture_counts_come_back_per_replay():
    from fbpic_tpu_torch.utils import kernels

    def wrapper():
        kernels.count_launch(wrapper)
    wrapper.launches = 0
    wrapper()
    assert kernels.launch_counts()[wrapper] == 1
    before = kernels.launch_counts()
    wrapper()                         # as a capture runs it
    delta = {fn: n - before.get(fn, 0)
             for fn, n in kernels.launch_counts().items()
             if n != before.get(fn, 0)}
    assert delta == {wrapper: 1}
    kernels.add_launches({fn: -n for fn, n in delta.items()})
    assert wrapper.launches == 1
    for _ in range(3):                # three replays
        kernels.add_launches(delta)
    assert wrapper.launches == 4

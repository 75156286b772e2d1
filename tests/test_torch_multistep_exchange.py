"""The exchange block inside the chunk runner's body (core/graph.py) on
the CPU, where the runner calls the body that a CUDA graph replays on
the card: removal, continuous injection and the fresh rho_prev read
their values from the step's table row (``StepScalars.exchange``, the
host's ``plan_exchange``), so a captured exchange step reads nothing
from the host.

- The runner against the eager step loop, bit for bit, on an open-z
  moving-window LWFA with continuous injection and thermal momenta
  (exchange steps at 0, 4, 8 and 12 of 13), for a resident, a ring and
  a tracked species: every tensor, the injection front, the cursors,
  the ids and the generator's state; the exchange blocks ran inside the
  body (their column counts were tensors).
- The runner against fbpic_tpu's ``make_multi_step`` on the same run
  with a density function, torch-evaluated in the port and jax.numpy in
  fbpic_tpu, fbpic_tpu's angles fed in (which keep the exchange eager):
  particles 1e-12 and fields 1e-8 of their scale, as
  tests/test_torch_multistep.py.
- The density probe (``probe_dens_func``, fbpic_tpu's
  ``ensure_traceable_dens``): a torch function goes to the device, a
  numpy one (``np.where``) stays on the host and ``graph_blockers``
  names it (its exchange then runs eagerly, the rest on the runner, bit
  for bit with the eager loop); both give the same run within 1e-12.
- PICMI's ``analytic_density`` on tensors (torch) against fbpic_tpu's
  jax.numpy evaluation within 4 float64 ulps, ``where``, ``maximum`` and
  ``minimum`` with Python numbers included.
- The exchange columns of the runner's tables equal the host's
  ``plan_exchange`` values bit for bit, float32 and float64, in the lab
  frame and a Galilean one, and the exchange block with them equals the
  block with the host's numbers bit for bit.
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
                  continuous_injection=True, ux_th=0.01, uz_th=0.01)
LASER_KW = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=-1.e-6)
GAMMA = 10.
N_STEPS = 13
RAMP = 3.e-6


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs several test processes side by side: cap torch's
    CPU threads so they do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def torch_density(z, r):
    """A density ramp written with torch on tensors (the injection) and
    numpy on host arrays (the initial load)."""
    lib = torch if torch.is_tensor(z) else np
    return 1. + 0.3 * lib.tanh((z - 2.e-6) / RAMP)


def jnp_density(z, r):
    import jax.numpy as jnp
    return 1. + 0.3 * jnp.tanh((z - 2.e-6) / RAMP)


def step_density(z, r):
    """A density step, torch on tensors."""
    if torch.is_tensor(z):
        return 1. + 0.2 * (z > 1.e-6).to(z.dtype)
    return 1. + 0.2 * (z > 1.e-6)


def numpy_density(z, r):
    """The same step, numpy only: the probe sends it to the host."""
    return np.where(z > 1.e-6, 1.2, 1.)


def port_sim(layout="resident", dtype=torch.float64, frame="lab",
             dens_func=None):
    """The open-z LWFA above in the port: a resident species (the fused
    deposit forced, sort_K 256), a ring (the scatter deposits) or a
    tracked resident one; or (frame "galilean") the same box in a
    boosted Galilean frame, n_move changing from step to step."""
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
    sim.use_fused_deposit = layout != "ring"
    view = sim.add_new_species(sort_K=0 if layout == "ring" else 256,
                               dens_func=dens_func, **SPECIES_KW)
    if layout == "tracked":
        view.track()
    add_laser_pulse(sim, GaussianLaser(**LASER_KW), **laser)
    sim.set_moving_window(v=c, **laser)
    assert sim.config.Nz == 64
    assert sim.species_configs[0].resident == (layout != "ring")
    return sim


def eager_steps(sim, n):
    """The eager step loop: prepare, then the eager step n times (its
    exchange block with the host's numbers), then the overflow read."""
    from fbpic_tpu_torch.core.step import make_step, prepare
    options = sim.build_options()
    step = make_step(sim.config, sim.species_configs, options)
    sim.state = prepare(sim.config, options, sim.species_configs, sim.state,
                        sim.aux)
    for _ in range(n):
        sim.state = step(sim.state, sim.aux, tuple(sim._injector_auxes),
                         sim.column_angles, sim.generator)
    sim._consume_overflow_counters()


def assert_same_run(a, b):
    """Every tensor, the host values, the injection front, the cursors
    and the generator's state of two runs equal."""
    from fbpic_tpu_torch.core.graph import state_tensors
    sa, sb = a.state, b.state
    assert (sa.iteration, float(sa.time), float(sa.zmin),
            float(sa.mw_zref)) == (sb.iteration, float(sb.time),
                                   float(sb.zmin), float(sb.mw_zref))
    ta, tb = state_tensors(sa), state_tensors(sb)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), i
    for pa, pb in zip(sa.species, sb.species):
        assert (int(pa.next_free), int(pa.next_id), float(pa.inj_z_end)) \
            == (int(pb.next_free), int(pb.next_id), float(pb.inj_z_end))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.overflow_totals == b.overflow_totals


class ColumnRecorder:
    """Records, for each continuous_injection call, whether its column
    count came from the step's scalars (a tensor) or from the host."""

    def __init__(self, monkeypatch):
        from fbpic_tpu_torch.core import step as step_mod
        self.calls = []
        real = step_mod.continuous_injection

        def record(sp, inj_cfg, inj_aux, columns, *args, **kwargs):
            self.calls.append(torch.is_tensor(columns[0]))
            return real(sp, inj_cfg, inj_aux, columns, *args, **kwargs)
        monkeypatch.setattr(step_mod, "continuous_injection", record)


# ---------------------------------------------------------------------
# (a) the runner against the eager step loop
# ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["resident", "ring", "tracked"])
def test_runner_matches_eager_steps(layout, monkeypatch):
    from fbpic_tpu_torch.core.graph import graph_blockers
    chunked, eager = port_sim(layout), port_sim(layout)
    assert graph_blockers(chunked, chunked.build_options()) == ([], [])
    rec = ColumnRecorder(monkeypatch)
    chunked.step(N_STEPS)
    inside = rec.calls
    rec.calls = []
    eager_steps(eager, N_STEPS)
    assert chunked._multi_step is not None
    # four exchange steps, each inside the runner's body
    assert inside == [True] * 4 and rec.calls == [False] * 4
    assert_same_run(chunked, eager)
    sp = chunked.state.species[0]
    if layout == "tracked":
        ids = sp.ids[sp.w != 0]
        assert sp.next_id > int(ids.max()) and ids.unique().numel() \
            == ids.numel()


# ---------------------------------------------------------------------
# (b) against fbpic_tpu's make_multi_step, a density function each
# ---------------------------------------------------------------------

def test_runner_matches_fbpic_multi_step_with_density():
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.lpa_utils.laser import add_laser_pulse as a0, \
        GaussianLaser as L0
    from fbpic_tpu_torch.core.graph import graph_blockers
    s0 = S0(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, **SIM_KW)
    s0.use_fused_deposit = True
    kw = dict(SPECIES_KW, ux_th=0., uz_th=0.)
    s0.add_new_species(dens_func=jnp_density, sort_K=256, **kw)
    a0(s0, L0(**LASER_KW))
    s0.set_moving_window(v=c)
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse as a1, \
        GaussianLaser as L1
    s1 = S1(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
            dtype=torch.float64, **SIM_KW)
    s1.use_fused_deposit = True
    s1.add_new_species(dens_func=torch_density, sort_K=256, **kw)
    a1(s1, L1(**LASER_KW))
    s1.set_moving_window(v=c)
    assert s1._injector_configs[0].dens_on_device
    s1.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    # fbpic_tpu's angles keep the exchange eager, the rest on the runner
    assert graph_blockers(s1, s1.build_options()) == (
        [], ["a column angle source other than the simulation's "
             "GeneratorAngles"])
    s0.step(20)
    s1.step(20)
    assert s1._multi_step is not None
    ref = jax_state_to_numpy(s0.state)
    st = s1.state
    assert st.iteration == ref["iteration"] == 20
    for n in ("time", "zmin", "mw_zref"):
        assert float(getattr(st, n)) == ref[n], n
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
    # the ramp reached the injected plasma: weights differ along z
    w = sp.w[sp.w != 0]
    assert float(w.max() / w.min()) > 1.1


# ---------------------------------------------------------------------
# (c) the density probe
# ---------------------------------------------------------------------

def test_probe_sends_torch_functions_to_the_device():
    from fbpic_tpu_torch.core.graph import graph_blockers
    from fbpic_tpu_torch.particles.injection import probe_dens_func

    def ufunc_density(z, r):
        return np.exp(-z / 1.e-5)
    for dtype in (torch.float32, torch.float64):
        assert probe_dens_func(torch_density, "zr", dtype=dtype)
        assert not probe_dens_func(numpy_density, "zr", dtype=dtype)
        # numpy's ufuncs pass a CPU tensor through (its __array_wrap__
        # gives a tensor back) but not one of the card: the probe keeps
        # them on the host on every device
        assert torch.is_tensor(ufunc_density(torch.zeros(4, dtype=dtype),
                                             None))
        assert not probe_dens_func(ufunc_density, "zr", dtype=dtype)
    assert not probe_dens_func(lambda x, y, z: 1., "xyz",
                               dtype=torch.float64)
    assert probe_dens_func(lambda x, y, z: 1. + 0. * x * y * z, "xyz",
                           dtype=torch.float64)
    on_device, on_host = port_sim(dens_func=step_density), \
        port_sim(dens_func=numpy_density)
    assert on_device._injector_configs[0].dens_on_device
    assert not on_host._injector_configs[0].dens_on_device
    assert graph_blockers(on_device, on_device.build_options()) == ([], [])
    reason = ("species 0's density function is evaluated on the host "
              "(the probe found no tensor of the device)")
    assert graph_blockers(on_host, on_host.build_options()) == (
        [], [reason])
    # another angle source is named too
    on_host.column_angles = lambda it, i, nkey: torch.zeros(nkey.shape)
    blockers = graph_blockers(on_host, on_host.build_options())
    assert blockers.loop == [] and len(blockers.exchange) == 2


def test_host_and_device_density_give_the_same_run(monkeypatch):
    on_device, on_host = port_sim(dens_func=step_density), \
        port_sim(dens_func=numpy_density)
    twin = port_sim(dens_func=numpy_density)
    rec = ColumnRecorder(monkeypatch)
    on_device.step(N_STEPS)
    assert rec.calls == [True] * 4
    rec.calls = []
    on_host.step(N_STEPS)
    # the host density keeps the exchange eager, the rest on the runner
    assert on_host._multi_step is not None and rec.calls == [False] * 4
    eager_steps(twin, N_STEPS)
    assert_same_run(on_host, twin)
    from fbpic_tpu_torch.core.graph import state_tensors
    for x, y in zip(state_tensors(on_device.state),
                    state_tensors(on_host.state)):
        if x.is_floating_point() or x.is_complex():
            _close(y.numpy(), x.numpy(), "state", 1e-12)
        else:
            assert torch.equal(x, y)
    # the density step weighed the injected columns
    plain = port_sim()
    plain.step(N_STEPS)
    w, w_plain = on_device.state.species[0].w, plain.state.species[0].w
    assert torch.equal(w != 0, w_plain != 0) and not torch.equal(w, w_plain)


# ---------------------------------------------------------------------
# (d) PICMI's analytic density with torch
# ---------------------------------------------------------------------

def test_picmi_analytic_density_with_torch_matches_jax_numpy():
    """(EXPRESSION: where, maximum and minimum with Python numbers,
    np.log1p) torch on tensors against jax.numpy within 4 float64
    ulps; on host arrays numpy as before; the probe sends it to the
    device in float32 and float64."""
    from test_torch_picmi import _captured_dens_func, _packages
    from fbpic_tpu_torch.particles.injection import probe_dens_func
    p0, p1 = _packages()
    rng = np.random.RandomState(5)
    z = rng.uniform(-2.e-6, 20.e-6, 4096)
    r = rng.uniform(0., 12.e-6, 4096)
    ref = np.asarray(_captured_dens_func(p0, False)(z, r))
    dens = _captured_dens_func(p1, True)
    out = dens(torch.as_tensor(z), torch.as_tensor(r))
    assert torch.is_tensor(out) and out.dtype == torch.float64
    out = out.numpy()
    assert (ref[z < 0] == 0).all() and (out[z < 0] == 0).all()
    live = z > 0
    np.testing.assert_array_max_ulp(ref[live], out[live], maxulp=4)
    assert isinstance(dens(z, r), np.ndarray)
    for dtype in (torch.float32, torch.float64):
        assert probe_dens_func(dens, "zr", dtype=dtype)
        got = dens(torch.as_tensor(z, dtype=dtype),
                   torch.as_tensor(r, dtype=dtype))
        assert got.dtype == dtype


# ---------------------------------------------------------------------
# (e) the exchange columns of the tables against the host's arithmetic
# ---------------------------------------------------------------------

def as_op(value, dtype):
    """A host number as a torch op of the working dtype rounds it (the
    Galilean frame's grid edge is a float64 host value in a float32
    run: the op rounds it to float32)."""
    return torch.tensor(float(value), dtype=dtype)


@pytest.mark.parametrize("frame", ["lab", "galilean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exchange_scalars_equal_host_values(dtype, frame):
    from fbpic_tpu_torch.core.graph import MultiStep, state_tensors
    from fbpic_tpu_torch.core.step import (
        make_step, plan_exchange, prepare)
    sim = port_sim(dtype=dtype, frame=frame)
    options = sim.build_options()
    step = make_step(sim.config, sim.species_configs, options)
    runner = MultiStep(sim.config, sim.species_configs, options)
    st = prepare(sim.config, options, sim.species_configs, sim.state,
                 sim.aux)
    runner._ensure_static(st, sim.aux, ())
    n = 9
    plans, rows, irows = runner._plan(st, n, ())
    runner._upload(rows, irows)
    args = (sim.aux, tuple(sim._injector_auxes), sim.column_angles,
            sim.generator)
    z_ends, zmin, n_ex, n_cols = [st.species[0].inj_z_end], st.zmin, 0, 0
    for k, plan in enumerate(plans):
        runner._index.fill_(k)
        values = runner._scalars(*runner._row()).exchange
        if plan.exchange:
            host = plan_exchange(sim.config, options, z_ends, zmin)
            (n_t, z_t, lo_t), (n_h, z_h, lo_h) = (values.injection[0],
                                                 host.injection[0])
            for a, b in zip(values.removal + (z_t, lo_t),
                            host.removal + (z_h, lo_h)):
                assert a.dtype == dtype and torch.equal(a, as_op(b, dtype))
            assert n_t.dtype == torch.int64 and int(n_t) == n_h
            n_cols += n_h
            assert float(runner._z_ends[k][0]) == float(
                host.z_end_after[0])
            z_ends = list(host.z_end_after)
            n_ex += 1
        zmin = plan.zmin_end
    assert n_ex == 3 and n_cols > 0
    # the exchange block with the table's values and with the host's
    runner._index.zero_()
    scalars = runner._scalars(*runner._row())
    gen = sim.generator.get_state()
    host = step.exchange(st, *args)
    sim.generator.set_state(gen)
    dev = step.exchange(st, *args, scalars=scalars)
    for i, (a, b) in enumerate(zip(state_tensors(host), state_tensors(dev))):
        assert torch.equal(a, b), i
    assert float(host.species[0].inj_z_end) == float(runner._z_ends[0][0])

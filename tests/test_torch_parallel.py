"""The z decomposition's building blocks: fbpic_tpu_torch.parallel against
fbpic_tpu.parallel (float64, CPU).

fbpic_tpu runs on the conftest's 8-device CPU mesh (shard_map +
ppermute), the port on 4 CPU slabs in threads of one process
(``devices=["cpu"] * 4``).  The same inputs, made from a numpy seed:

- the guard exchanges (add and replace) on random complex fields:
  exactly equal;
- particle migration (periodic, a globally open box, a buffer too small
  and a slab without dead slots): the same slots, exactly, and the same
  lost count;
- ``local_grid_config`` field by field and ``particle_dp_shardings``'s
  rule; the ``make_mesh`` refusals;
- a slab that raises ends the run with its own exception, in seconds;
  a slab that skips a collective ends it at the barrier's timeout;
- the port started from fbpic_tpu's decomposed state
  (``utils.carry.slab_states_from_numpy``) after 8 steps of
  tests/test_torch_parallel_run.py's LWFA with exchange_period 4: one
  more exchange period in both, fields within 1e-8, particles slot by
  slot within 1e-12;
- tests/test_multichip.py's plasma wave through ``make_multichip_step``,
  4 slabs against fbpic_tpu's 4-device run, 30 steps: E, B and rho
  within 1e-10 of their scale, the corrected J within 1e-8, the
  particles within 1e-12.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

N_DEV = 4
Nm, Nr, G = 2, 8, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the slabs are the parallelism.  Under the
    suite's parallel workers, 4 slab threads of 2 intra-op threads each
    ran 3x slower than of 1 (measured on the resident mesh of
    tests/test_torch_parallel_run.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh():
    from fbpic_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs %d JAX devices" % N_DEV)
    return make_mesh(N_DEV, axis_name="z")


def _port_group():
    from fbpic_tpu_torch.parallel import SlabGroup
    return SlabGroup(["cpu"] * N_DEV)


def _fields(rng, Nzl):
    return [rng.standard_normal((Nm, N_DEV * Nzl, Nr))
            + 1j * rng.standard_normal((Nm, N_DEV * Nzl, Nr))
            for _ in range(2)]


@pytest.mark.parametrize("kind", ["add", "replace"])
def test_guard_exchange_matches_fbpic_tpu(kind):
    from fbpic_tpu.parallel import domain as jdom
    from fbpic_tpu.utils.complex_arr import CArr
    from fbpic_tpu_torch.parallel import domain as pdom
    Nzl = 4 * G + 5
    fields = _fields(np.random.RandomState(1), Nzl)
    jfn = getattr(jdom, f"exchange_guards_{kind}")
    pfn = getattr(pdom, f"exchange_guards_{kind}")

    def body(*parts):
        outs = jfn([CArr(parts[2 * k], parts[2 * k + 1])
                    for k in range(len(fields))], G, "z")
        return tuple(x for F in outs for x in (F.re, F.im))
    spec = (P(None, "z", None),) * (2 * len(fields))
    ref = jax.jit(shard_map(body, mesh=_jax_mesh(), in_specs=spec,
                            out_specs=spec, check_vma=False))(
        *[jnp.asarray(x) for F in fields for x in (F.real, F.imag)])
    ref = [np.asarray(ref[2 * k]) + 1j * np.asarray(ref[2 * k + 1])
           for k in range(len(fields))]

    group = _port_group()

    def slab(rank):
        mine = [torch.as_tensor(F[:, rank * Nzl:(rank + 1) * Nzl])
                for F in fields]
        return pfn(mine, G, group.comm(rank))
    outs = group.run(slab)
    for k, F in enumerate(ref):
        got = np.concatenate([o[k].numpy() for o in outs], axis=1)
        np.testing.assert_array_equal(got, F)


def _jax_local_config(Nz_int=20, n_guard=G):
    from fbpic_tpu.fields.solver import GridConfig
    dz = 0.1e-6
    return GridConfig(Nz=N_DEV * Nz_int, Nr=Nr, Nm=Nm, dz=dz, dr=0.2e-6,
                      rmax=Nr * 0.2e-6, dt=dz / 3e8, n_order=8)


def _random_species(rng, Nzl, cap, n_live, dz, with_level, full_slab=None):
    """Per-slab particles spread over the extended slab (some in each
    guard, so they migrate both ways), the dead slots scattered; slab
    ``full_slab`` has no dead slot and keeps its particles."""
    out = []
    for i in range(N_DEV):
        zmin_loc = (i * (Nzl - 2 * G) - G) * dz
        live = np.zeros(cap, bool)
        live[rng.choice(cap, cap if i == full_slab else n_live,
                        replace=False)] = True
        d = {n: rng.standard_normal(cap) for n in
             ("x", "y", "ux", "uy", "uz")}
        lo, hi = (G, Nzl - G) if i == full_slab else (G - 4, Nzl - G + 4)
        d["z"] = zmin_loc + rng.uniform(lo, hi, cap) * dz
        d["inv_gamma"] = rng.uniform(0.5, 1.0, cap)
        d["w"] = np.where(live, rng.uniform(1.0, 2.0, cap), 0.0)
        if with_level:
            d["ionization_level"] = np.where(
                live, rng.randint(1, 5, cap), 0).astype(np.uint8)
        out.append(d)
    return out


@pytest.mark.parametrize("case,global_open,buffer_size,n_live", [
    ("periodic", False, 64, 150),
    ("global_open", True, 64, 150),
    ("small_buffer", False, 4, 150),
    ("no_dead_slots", False, 64, 150),
])
def test_migrate_particles_matches_fbpic_tpu(case, global_open, buffer_size,
                                             n_live):
    from fbpic_tpu.parallel import domain as jdom
    from fbpic_tpu.particles.state import ParticleState as JP
    from fbpic_tpu_torch.parallel import domain as pdom
    from fbpic_tpu_torch.particles.state import ParticleState as PP
    from fbpic_tpu_torch.utils.carry import config_from
    cfg_g = _jax_local_config()
    cfg_l = jdom.local_grid_config(cfg_g, N_DEV, G)
    Nzl, dz, cap = cfg_l.Nz, cfg_l.dz, 256
    slabs = _random_species(np.random.RandomState(7), Nzl, cap, n_live, dz,
                            with_level=True,
                            full_slab=0 if case == "no_dead_slots" else None)
    names = list(slabs[0])
    glob = {n: np.concatenate([s[n] for s in slabs]) for n in names}

    def body(sp):
        idx = jax.lax.axis_index("z")
        zmin = 0.0 + (idx * (Nzl - 2 * G) - G) * dz
        sp, lost = jdom.migrate_particles(sp, cfg_l, zmin, "z", buffer_size,
                                          global_open=global_open)
        return sp, lost[None]
    jsp = JP(**{n: jnp.asarray(v) for n, v in glob.items()})
    ref, lost_ref = jax.jit(shard_map(
        body, mesh=_jax_mesh(), in_specs=(P("z"),),
        out_specs=(P("z"), P("z")), check_vma=False))(jsp)

    group = _port_group()
    cfg_lp = config_from(cfg_l)

    def slab(rank):
        d = slabs[rank]
        sp = PP(**{n: torch.as_tensor(d[n].astype(np.int32)
                                      if n == "ionization_level" else d[n])
                   for n in names})
        zmin = np.float64(0.0) + np.float64(rank * (Nzl - 2 * G) - G) \
            * np.float64(dz)
        return pdom.migrate_particles(sp, cfg_lp, zmin, group.comm(rank),
                                      buffer_size, global_open=global_open)
    outs = group.run(slab)
    lost = [int(o[1]) for o in outs]
    np.testing.assert_array_equal(lost, np.asarray(lost_ref))
    if case in ("small_buffer", "no_dead_slots"):
        assert sum(lost) > 0
    else:
        assert sum(lost) == 0
    for n in names:
        got = np.concatenate([getattr(o[0], n).numpy() for o in outs])
        np.testing.assert_array_equal(
            got, np.asarray(getattr(ref, n)).astype(got.dtype), err_msg=n)
    if case == "periodic":
        # nothing lost, nothing created: the live weight is conserved
        assert np.isclose(sum(float(o[0].w.sum()) for o in outs),
                          glob["w"].sum(), rtol=1e-14)


@pytest.mark.parametrize("boundaries", ["periodic", "open"])
def test_local_grid_config_matches_fbpic_tpu(boundaries):
    import dataclasses
    from fbpic_tpu.fields.solver import GridConfig
    from fbpic_tpu.parallel.domain import local_grid_config as j_local
    from fbpic_tpu_torch.parallel import local_grid_config as p_local
    from fbpic_tpu_torch.utils.carry import config_from
    kw = dict(n_guard=10, nz_damp=16, n_inject=5) if boundaries == "open" \
        else {}
    cfg = GridConfig(Nz=120, Nr=16, Nm=2, dz=0.1, dr=0.2, rmax=3.2, dt=1e-9,
                     n_order=16, boundaries_z=boundaries, **kw)
    ref = j_local(cfg, 4, 12)
    got = p_local(config_from(cfg), 4, 12)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    with pytest.raises(ValueError, match="divisible"):
        p_local(config_from(cfg), 7, 12)


def test_particle_dp_shardings_rule_matches_fbpic_tpu():
    from fbpic_tpu import Simulation as S0
    from fbpic_tpu.parallel.mesh import particle_dp_shardings as j_rule
    from fbpic_tpu_torch import Simulation as S1
    from fbpic_tpu_torch.parallel import make_mesh, particle_dp_shardings
    kw = dict(p_zmin=0., p_zmax=4e-6, p_rmax=2e-6, p_nz=1, p_nr=1, p_nt=2,
              n_e=1e24, verbose_level=0)
    s0 = S0(16, 4e-6, 8, 2e-6, 2, 1e-15, **kw)
    s1 = S1(16, 4e-6, 8, 2e-6, 2, 1e-15, device="cpu", dtype=torch.float64,
            **kw)
    from fbpic_tpu.parallel.mesh import make_mesh as j_mesh
    _jax_mesh()
    ref = j_rule(j_mesh(N_DEV, axis_name="p"), s0.state, axis_name="p")
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    got = particle_dp_shardings(make_mesh(devices=["cpu"] * 2), s1.state)
    checked = 0
    for path, sharding in flat:
        key = jax.tree_util.keystr(path)
        key = key[:-3] if key.endswith((".re", ".im")) else key
        if key in got:
            assert tuple(sharding.spec) == got[key], key
            checked += 1
    assert checked >= 15
    assert got[".species[0].x"] == ("p",) and got[".spect.Ez"] == ()


def test_make_mesh_refusals(monkeypatch):
    from fbpic_tpu_torch.parallel import make_mesh
    assert make_mesh(devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError, match="n_devices=2 but 1"):
        make_mesh(2, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices=["cuda:0", "cuda:0"])
    # fbpic_tpu's refusal of more devices than exist, on a one-card host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested a 4-device mesh but "
                                         "only 1 device"):
        make_mesh(4)
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        make_mesh(devices=["cuda:0", "cuda:1"])
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:0"]
    assert make_mesh(1).size == 1


class SlabFault(Exception):
    pass


def test_a_slab_that_raises_fails_the_run_without_a_hang():
    """Slab 2 raises after a few collectives; the others are blocked at
    (or reach) the barrier and leave with BrokenBarrierError; the run
    raises slab 2's exception, long before the barrier's timeout."""
    from fbpic_tpu_torch.parallel import SlabGroup
    group = SlabGroup(["cpu"] * N_DEV, timeout=120.0)

    def slab(rank):
        comm = group.comm(rank)
        for k in range(1000):
            comm.psum(torch.ones(()))
            if rank == 2 and k == 5:
                raise SlabFault("slab 2 failed")
        return rank

    t0 = time.perf_counter()
    with pytest.raises(SlabFault, match="slab 2 failed"):
        group.run(slab)
    assert time.perf_counter() - t0 < 10.0
    assert threading.active_count() < 10
    # the group runs again afterwards
    assert group.run(lambda r: group.comm(r).psum(r)) == [6] * N_DEV


def test_a_slab_that_raises_in_a_step_fails_distribute_run():
    """The same through DistributedRun: a capture on slab 1 that raises
    at its third step ends run.step with that exception."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.parallel import distribute_simulation
    sim = Simulation(64, 6.4e-6, 8, 2e-6, 1, 0.1e-6 / 3e8, n_order=8,
                     p_zmin=0., p_zmax=6.4e-6, p_rmax=1.5e-6, p_nz=1, p_nr=1,
                     p_nt=2, n_e=1e24, verbose_level=0, device="cpu",
                     dtype=torch.float64)
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV)
    calls = []

    def faulty(state, aux, comm):
        if comm.rank == 1:
            calls.append(state.iteration)
            if len(calls) == 3:
                raise SlabFault("capture failed on slab 1")
    from fbpic_tpu_torch.parallel import domain
    run.multi_step, _ = domain.make_multichip_step(
        sim.config, tuple(sim.species_configs), sim.build_options(),
        run.mesh, n_guard=run.g, capture_fns=(faulty,), group=run.group)
    t0 = time.perf_counter()
    with pytest.raises(SlabFault, match="slab 1"):
        run.step(10)
    assert time.perf_counter() - t0 < 30.0


def test_a_missing_slab_ends_the_run_at_the_timeout():
    from fbpic_tpu_torch.parallel import SlabGroup
    group = SlabGroup(["cpu"] * 2, timeout=1.0)

    def slab(rank):
        if rank == 0:
            group.comm(rank).psum(1)
        return rank
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="waited more than 1.0 s"):
        group.run(slab)
    assert time.perf_counter() - t0 < 10.0


def test_plasma_wave_on_4_slabs_matches_fbpic_tpu_mesh():
    """tests/test_multichip.py's periodic plasma wave through both
    packages' make_multichip_step (n_guard 24, migration buffer 1024),
    30 steps on 4 slabs: every spectral and interpolation field within
    1e-10 of its family's scale (E, B, rho: the m = 1 components of
    this axisymmetric wave are roundoff), the particles (slot by slot)
    within 1e-12, no migration loss.  The corrected current J within
    1e-8: the curl-free correction amplifies the float64 roundoff of
    the deposits, summed and transformed in another order (an FFT here,
    a DFT matrix there), as on one device (tests/test_torch_step.py);
    the fields it drives stay within 1e-10."""
    import test_multichip as tm
    from fbpic_tpu.fields.solver import GridConfig, build_field_aux
    from fbpic_tpu.core.step import StepOptions
    from fbpic_tpu.particles.state import SpeciesConfig
    from fbpic_tpu.parallel import domain as jdom
    from fbpic_tpu_torch.parallel import domain as pdom, make_mesh
    from fbpic_tpu_torch.core.step import StepOptions as PO
    from fbpic_tpu_torch.particles.state import SpeciesConfig as PSC
    from fbpic_tpu_torch.utils.carry import config_from
    n_steps = 30
    parts = tm._make_particles()
    cfg = GridConfig(Nz=tm.Nz, Nr=tm.Nr, Nm=tm.Nm, dz=tm.zmax / tm.Nz,
                     dr=tm.rmax / tm.Nr, rmax=tm.rmax, dt=tm.dt,
                     n_order=tm.n_order)
    jstep, jcl = jdom.make_multichip_step(
        cfg, (SpeciesConfig(q=-tm.e, m=tm.m_e),),
        StepOptions(rmax_gather=tm.rmax), _jax_mesh(), axis_name="z",
        migration_buffer=1024, n_guard=24)
    jst = jdom.build_multichip_state(cfg, jcl, N_DEV, [parts])
    jst = jax.jit(jstep, static_argnums=2)(jst, build_field_aux(jcl),
                                           n_steps)

    pc = config_from(cfg)
    pstep, pcl = pdom.make_multichip_step(
        pc, (PSC(q=-tm.e, m=tm.m_e),), PO(rmax_gather=tm.rmax),
        make_mesh(devices=["cpu"] * N_DEV), migration_buffer=1024,
        n_guard=24)
    assert pcl.Nz == jcl.Nz and pstep.exchange_period == 1
    aux = pdom.local_aux(pcl, device="cpu", dtype=torch.float64)
    pst = pdom.build_multichip_state(pc, pcl, N_DEV, [parts],
                                     devices=["cpu"] * N_DEV)
    pst = pstep(pst, [aux] * N_DEV, n_steps)

    assert all(s.iteration == n_steps for s in pst)
    assert int(jst.migration_overflow) == 0
    assert [int(s.migration_overflow) for s in pst] == [0] * N_DEV
    families = {"spect": (("Ep", "Em", "Ez"), ("Bp", "Bm", "Bz"),
                          ("Jp", "Jm", "Jz"), ("rho_prev",)),
                "interp": (("Er", "Et", "Ez"), ("Br", "Bt", "Bz"))}
    for part, groups in families.items():
        for names in groups:
            ref = [getattr(getattr(jst, part), n).to_numpy() for n in names]
            got = [np.concatenate([getattr(getattr(s, part), n).numpy()
                                   for s in pst], axis=1) for n in names]
            scale = max(np.abs(r).max() for r in ref)
            assert scale > 0, names
            tol = 1e-8 if names[0] == "Jp" else 1e-10
            for n, r, o in zip(names, ref, got):
                assert np.abs(o - r).max() <= tol * scale, (part, n)
    u_scale = max(np.abs(np.asarray(getattr(jst.species[0], n))).max()
                  for n in ("ux", "uy", "uz"))
    for name in ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w"):
        ref = np.asarray(getattr(jst.species[0], name))
        got = np.concatenate([getattr(s.species[0], name).numpy()
                              for s in pst])
        scale = u_scale if name.startswith("u") else np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-12 * scale, name


def test_distribute_refuses_what_cannot_be_decomposed():
    """fbpic_tpu's refusals: the infinite-order stencil has no reach
    (no default n_guard), and the internal Nz must divide by the slab
    count."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.parallel import distribute_simulation
    kw = dict(verbose_level=0, device="cpu", dtype=torch.float64)
    sim = Simulation(64, 6.4e-6, 8, 2e-6, 1, 0.1e-6 / 3e8, **kw)
    with pytest.raises(ValueError, match="finite stencil order"):
        distribute_simulation(sim, devices=["cpu"] * 2)
    sim = Simulation(64, 6.4e-6, 8, 2e-6, 1, 0.1e-6 / 3e8, n_order=8, **kw)
    with pytest.raises(ValueError, match="divisible"):
        distribute_simulation(sim, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="on_migration_overflow"):
        distribute_simulation(sim, devices=["cpu"] * 2,
                              on_migration_overflow="ignore")


def test_collectives_and_launch_counts_under_thread_stress():
    """16 slabs (more than the cores) switching threads every
    microsecond: every psum, ring shift and all_gather of 300 rounds
    gives each slab the expected values (a mailbox slot overwritten
    before a slow slab read it would break them), and the launch
    counters lose no update."""
    import sys
    from fbpic_tpu_torch.parallel import SlabGroup
    from fbpic_tpu_torch.utils import kernels
    n, rounds = 16, 300

    def fake_kernel():
        kernels.count_launch(fake_kernel)
    fake_kernel.launches = 0
    group = SlabGroup(["cpu"] * n, timeout=120.0)

    def slab(rank):
        comm = group.comm(rank)
        for k in range(rounds):
            fake_kernel()
            total = comm.psum(torch.tensor(float(rank + k)))
            assert float(total) == n * (n - 1) / 2 + n * k
            left, right = comm.shift_both([torch.tensor(rank * 1000 + k)],
                                          [torch.tensor(rank * 1000 + k)])
            assert int(left[0]) == ((rank - 1) % n) * 1000 + k
            assert int(right[0]) == ((rank + 1) % n) * 1000 + k
            assert comm.all_gather(k) == [k] * n
        return rank

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        assert group.run(slab) == list(range(n))
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 60.0
    assert fake_kernel.launches == n * rounds
    assert fake_kernel.launches_by_slab == {r: rounds for r in range(n)}


def test_port_continues_fbpic_tpu_mesh_state():
    from test_torch_step import jax_column_angles, jax_state_to_numpy
    from test_torch_parallel_run import lwfa
    from fbpic_tpu.parallel.api import distribute_simulation as j_dist
    from fbpic_tpu_torch.parallel import distribute_simulation
    from fbpic_tpu_torch.utils.carry import slab_states_from_numpy
    s0 = lwfa("fbpic_tpu", exchange_period=4)
    r0 = j_dist(s0, n_devices=N_DEV, n_guard=24)
    r0.step(8)
    sim = lwfa("fbpic_tpu_torch", exchange_period=4)
    sim.column_angles = jax_column_angles(int(s0.state.seed), torch.float64)
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV, n_guard=24)
    assert run.exchange_period == 4
    carried = jax_state_to_numpy(r0.state)
    run.states = slab_states_from_numpy(
        **carried, n_slabs=N_DEV, devices="cpu",
        migration_overflow=int(r0.state.migration_overflow))
    run.iteration = 8
    assert all(s.species[0].capacity == run.states[0].species[0].capacity
               for s in run.states)
    r0.step(4)
    run.step(4)
    ref = jax_state_to_numpy(r0.state)
    Nzl = run.config_local.Nz
    for part in ("spect", "interp"):
        for name, arr in ref[part].items():
            got = np.concatenate([getattr(getattr(s, part), name).numpy()
                                  for s in run.states], axis=1)
            assert got.shape[1] == N_DEV * Nzl
            scale = np.abs(arr).max()
            assert np.abs(got - arr).max() <= 1e-8 * max(scale, 1e-300), \
                (part, name)
    sp = ref["species"][0]
    w = np.concatenate([s.species[0].w.numpy() for s in run.states])
    np.testing.assert_array_equal(w != 0, sp["w"] != 0)
    for name in ("x", "y", "z", "ux", "uy", "uz", "w"):
        got = np.concatenate([getattr(s.species[0], name).numpy()
                              for s in run.states])
        live = sp["w"] != 0
        scale = np.abs(sp[name][live]).max()
        assert np.abs(got[live] - sp[name][live]).max() <= 1e-12 * scale, \
            name
    assert all(s.species[0].next_free == sp["next_free"]
               for s in run.states)

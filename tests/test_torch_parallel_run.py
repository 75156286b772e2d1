"""distribute_simulation end to end on CPU slabs (float64).

- tests/test_multichip.py's moving-window LWFA (open z, continuous
  injection, a0 = 0.5 laser, exchange_period 1), 50 steps on 4 slabs,
  the port fed fbpic_tpu's injection angles: against the port's single
  card run at fbpic_tpu's own gate (Ez within 5e-3 of its scale: the
  per-slab current correction's locality), the live count and the total
  weight equal; and against fbpic_tpu's 4-device run: the fields within
  1e-8 of their scale (tests/test_torch_step.py's tolerance), every slab's
  live slots exactly, the live particles' positions and momenta within
  1e-8 of their vector's scale (50 laser steps amplify the fields'
  float64 roundoff, 3e-12 here, in the orbits), the cursors exactly;
- tests/test_resident.py's resident mesh (n_guard 24, exchange_period
  4, sort_K 256, 40 steps): the resident layout on every slab, Ez within
  5e-3 of the single card's;
- the gather_state / sync_to_sim round trip;
- tests/test_migration_regression.py's no-silent-loss case (8 slabs,
  n_guard 8, a 2048-slot migration buffer above half the slab
  capacity).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c, e, m_e  # noqa: E402

N_DEV = 4
NZ_PHYS, NR, NM = 130, 20, 2
ZMAX, ZMIN, RMAX = 12.e-6, -4.e-6, 10.e-6
DT = (ZMAX - ZMIN) / NZ_PHYS / c
LWFA_KW = dict(p_zmin=2.e-6, p_zmax=200.e-6, p_rmin=0., p_rmax=9.e-6,
               p_nz=1, p_nr=2, p_nt=4, n_e=5.e24, zmin=ZMIN, n_order=16,
               boundaries={"z": "open", "r": "reflective"},
               exchange_period=1, random_seed=0, verbose_level=0)
LASER_KW = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=6.e-6)


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


def lwfa(pkg, Nr=NR, **kw):
    """The LWFA of tests/test_multichip.py in fbpic_tpu or the port
    (CPU, float64)."""
    import importlib
    mod = importlib.import_module(pkg)
    laser = importlib.import_module(pkg + ".lpa_utils.laser")
    if pkg == "fbpic_tpu_torch":
        kw = dict(kw, device="cpu", dtype=torch.float64)
    sim = mod.Simulation(NZ_PHYS, ZMAX, Nr, RMAX, NM, DT, **dict(LWFA_KW,
                                                                 **kw))
    laser.add_laser_pulse(sim, laser.GaussianLaser(**LASER_KW))
    sim.set_moving_window(v=c)
    return sim


def ez_full(sim):
    """Mode 0 of Ez on the single card's internal grid."""
    from fbpic_tpu_torch.fields import transform as tr
    return tr.spect2interp_scal(sim.aux.mats, sim.state.spect.Ez).numpy()[0]


def rel(a, b):
    return np.abs(a - b).max() / np.abs(a).max()


def test_lwfa_on_4_slabs_matches_single_card_and_fbpic_tpu_mesh():
    from test_torch_step import jax_column_angles
    from fbpic_tpu.parallel.api import distribute_simulation as j_dist
    from fbpic_tpu_torch.parallel import distribute_simulation
    n_steps = 50
    s0 = lwfa("fbpic_tpu")
    angles = jax_column_angles(int(s0.state.seed), torch.float64)
    r0 = j_dist(s0, n_devices=N_DEV)
    r0.step(n_steps)

    single = lwfa("fbpic_tpu_torch")
    single.column_angles = angles
    single.step(n_steps)
    sim = lwfa("fbpic_tpu_torch")
    sim.column_angles = angles
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV)
    assert run.exchange_period == 1 and run.config_local.Nz == 188
    run.step(n_steps)

    # against the port's single card: fbpic_tpu's own multichip gate
    Ez1, Ez4 = ez_full(single), run.get_interp_field("Ez", 0)
    assert np.abs(Ez1).max() > 0
    assert rel(Ez1, Ez4) < 5e-3
    live = [s.species[0].w != 0 for s in run.states]
    assert sum(int(m.sum()) for m in live) == int(
        (single.state.species[0].w != 0).sum())
    w4 = sum(float(s.species[0].w.sum()) for s in run.states)
    assert np.isclose(w4, float(single.state.species[0].w.sum()),
                      rtol=1e-12)
    assert run.overflow_totals == {"migration_overflow": 0,
                                   "sort_overflow": 0, "ring_overwrite": 0}

    # against fbpic_tpu's 4-device run; its "rho" is each slab's
    # rho_prev as it lies, the port's "rho_prev" (the port's "rho"
    # record sums it over the halo, tests/test_torch_parallel_diag.py)
    for name in ("Er", "Et", "Ez", "Br", "Bt", "Bz", "rho"):
        for m in range(NM):
            ref = r0.get_interp_field(name, m)
            got = run.get_interp_field("rho_prev" if name == "rho"
                                       else name, m)
            scale = np.abs(r0.get_interp_field(name, 0)).max()
            assert np.abs(got - ref).max() <= 1e-8 * scale, (name, m)
    sp0 = r0.state.species[0]
    blocks = {n: np.asarray(getattr(sp0, n)).reshape(N_DEV, -1)
              for n in ("x", "y", "z", "ux", "uy", "uz", "w")}
    scales = {v: max(np.abs(blocks[n]).max() for n in names)
              for v, names in (("pos", "xyz"), ("mom", ("ux", "uy", "uz")))}
    for i, st in enumerate(run.states):
        sp = st.species[0]
        assert sp.next_free == int(sp0.next_free)
        assert float(sp.inj_z_end) == float(sp0.inj_z_end)
        np.testing.assert_array_equal(sp.w.numpy(), blocks["w"][i])
        live = blocks["w"][i] != 0
        for n in ("x", "y", "z", "ux", "uy", "uz") if live.any() else ():
            scale = scales["pos" if n in "xyz" else "mom"]
            diff = getattr(sp, n).numpy()[live] - blocks[n][i][live]
            assert np.abs(diff).max() <= 1e-8 * scale, (i, n)
    assert st.iteration == int(r0.state.iteration) == n_steps
    assert float(st.zmin) == float(r0.state.zmin)


def test_resident_layout_on_4_slabs_matches_single_card():
    """tests/test_resident.py:240's configuration: banded re-sorts
    between exchanges, full re-sorts on the migration / injection steps,
    the window's row roll and dead-slot injection, per slab."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    from fbpic_tpu_torch.parallel import distribute_simulation
    n_steps = 40

    def build():
        sim = Simulation(NZ_PHYS, ZMAX, 16, RMAX, NM, DT, zmin=ZMIN,
                         n_order=16, boundaries={"z": "open",
                                                 "r": "reflective"},
                         exchange_period=4, random_seed=0, verbose_level=0,
                         device="cpu", dtype=torch.float64)
        sim.use_fused_deposit = True
        sim.add_new_species(q=-e, m=m_e, n=5.e24, p_zmin=2.e-6,
                            p_zmax=100.e-6, p_rmin=0., p_rmax=9.e-6, p_nz=1,
                            p_nr=2, p_nt=4, continuous_injection=True,
                            sort_K=256)
        add_laser_pulse(sim, GaussianLaser(**LASER_KW))
        sim.set_moving_window(v=c)
        assert sim.species_configs[0].resident
        assert sim.species_configs[0].resort == "banded"
        return sim

    single = build()
    single.step(n_steps)
    run = distribute_simulation(build(), devices=["cpu"] * N_DEV, n_guard=24)
    assert 0 in run._resident_idx and run.exchange_period == 4
    K = single.species_configs[0].sort_K
    assert all(s.species[0].capacity == run.config_local.Nz * K
               for s in run.states)
    run.step(n_steps)
    Ez1, Ez4 = ez_full(single), run.get_interp_field("Ez", 0)
    assert np.abs(Ez1).max() > 0
    assert rel(Ez1, Ez4) < 5e-3
    assert run.overflow_totals["migration_overflow"] == 0
    assert run.overflow_totals["sort_overflow"] == 0


def test_gather_state_and_sync_to_sim_round_trip():
    """Distributing and gathering gives back the state a single-card
    step() call starts from: spectral E/B refreshed from the
    interpolation grid (a field set there before distributing included)
    and rho_prev deposited (the fields through the partial-space basis
    change, to float64 roundoff; the live particles exactly, in slab
    order); after steps, sync_to_sim installs the decomposed state: the
    Simulation's own accessors see the run's fields and particles."""
    import dataclasses
    from fbpic_tpu_torch.parallel import distribute_simulation
    sim, single = lwfa("fbpic_tpu_torch"), lwfa("fbpic_tpu_torch")
    for s in (sim, single):
        z = s.zmin + (torch.arange(s.config.Nz, dtype=torch.float64)
                      + 0.5) * s.config.dz
        bump = torch.zeros_like(s.state.interp.Er)
        bump[0] = 1e11 * torch.exp(-((z - 2.e-6) / 1.e-6) ** 2)[:, None]
        s.state = dataclasses.replace(s.state, interp=dataclasses.replace(
            s.state.interp, Er=s.state.interp.Er + bump))
    single.step(0)
    ref = single.state
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV)
    got = run.gather_state()
    for part in ("spect", "interp"):
        for name in ("Ez", "Bz", "Ep", "Em", "Bm", "rho_prev") \
                if part == "spect" else ("Er", "Et", "Ez", "Bt"):
            a = getattr(getattr(ref, part), name).numpy()
            b = getattr(getattr(got, part), name).numpy()
            assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max(), name
    sp_a, sp_b = ref.species[0], got.species[0]
    assert sp_b.capacity == sp_a.capacity
    live_a, live_b = sp_a.w != 0, sp_b.w != 0
    assert int(live_a.sum()) == int(live_b.sum())
    for n in ("x", "y", "z", "ux", "uy", "uz", "w"):
        a = np.sort(getattr(sp_a, n)[live_a].numpy())
        b = np.sort(getattr(sp_b, n)[live_b].numpy())
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert got.zmin == ref.zmin and got.iteration == ref.iteration

    run.step(6)
    run.sync_to_sim()
    assert sim.iteration == 6 and sim.zmin == float(run.states[0].zmin)
    nd = sim.nd_edge
    Ez = sim.get_interp_field("Ez", 0)
    np.testing.assert_allclose(
        Ez, run.get_interp_field("Ez", 0)[nd:nd + sim.Nz_phys],
        rtol=0, atol=1e-12 * np.abs(Ez).max())
    n_run = sum(int((s.species[0].w != 0).sum()) for s in run.states)
    assert sim.ptcl[0].Ntot == n_run


def test_migration_never_loses_particles_silently():
    """tests/test_migration_regression.py: 8 slabs of 26 cells, n_guard
    8, the migration buffer (2048) above half a slab's capacity: no
    particle is lost, and the weight total matches the single card's."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.parallel import distribute_simulation
    n_steps, n_dev = 6, 8

    def build():
        Nz_phys, zmax, zmin = 32, 4.e-6, -2.e-6
        dz = (zmax - zmin) / Nz_phys
        sim = Simulation(
            Nz_phys, zmax, 12, 4.e-6, 2, dz / c, p_zmin=0., p_zmax=50.e-6,
            p_rmin=0., p_rmax=3.5e-6, p_nz=1, p_nr=1, p_nt=4, n_e=1.e24,
            zmin=zmin, n_order=8, boundaries={"z": "open", "r": "reflective"},
            n_damp={"z": 63, "r": 0}, exchange_period=1, random_seed=0,
            verbose_level=0, device="cpu", dtype=torch.float64)
        sim.set_moving_window(v=c)
        return sim
    single = build()
    single.step(n_steps)
    w1 = float(single.state.species[0].w.sum())
    sim = build()
    assert sim.config.Nz == 208
    run = distribute_simulation(sim, devices=["cpu"] * n_dev, n_guard=8,
                                migration_buffer=2048)
    assert run.states[0].species[0].capacity < 2 * 2048
    run.step(n_steps)
    assert run.overflow_totals["migration_overflow"] == 0
    w8 = sum(float(s.species[0].w.sum()) for s in run.states)
    assert w1 > 0
    assert abs(w8 - w1) / w1 < 1e-9

"""distribute_simulation on the configurations of
tests/test_multichip_configs.py and _processes.py: the port on
4 CPU slabs against the port on one device, float64, at fbpic_tpu's own
tolerances for the same comparison.

- the radial PML (periodic z, a tightly focused laser into the PML,
  the correction off): Ez within 1e-6 (the exchange is exact in vacuum);
- the Galilean scheme (a laser in the comoving frame): 1e-6;
- cubic shapes on the plasma wave: 5e-3 (the per-slab correction);
- ionization on the slabs: the electrons' tracking ids unique across
  slabs (the rank prescan), one electron per ionization event; and
  against fbpic_tpu's 4-device run with fbpic_tpu's per-rank draws (the
  rank folded into the key): every slab's levels, live slots and ids
  exactly, the particles within 1e-12 of their vector's scale;
- Compton scattering on the slabs: the photons' ids unique, their count
  growing from chunk to chunk (the replicated cursor).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fbpic_tpu.constants import c, e, m_e, m_p, epsilon_0  # noqa: E402

N_DEV = 4
CPU = dict(device="cpu", dtype=torch.float64)


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


def ez_full(sim):
    from fbpic_tpu_torch.fields import transform as tr
    return tr.spect2interp_scal(sim.aux.mats, sim.state.spect.Ez).numpy()[0]


def mesh_vs_single(build, n_steps, step_kw=None, **dist_kw):
    """(single-device Ez, decomposed Ez, the run) after n_steps."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    single = build()
    single.step(n_steps, **(step_kw or {}))
    run = distribute_simulation(build(), devices=["cpu"] * N_DEV,
                                **dist_kw, **(step_kw or {}))
    run.step(n_steps)
    return ez_full(single), run.get_interp_field("Ez", 0), run


def rel(a, b):
    assert np.abs(a).max() > 0
    return np.abs(a - b).max() / np.abs(a).max()


def test_pml_on_slabs_matches_single_card():
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    Nz, Nr, zmax, rmax = 128, 24, 12.8e-6, 6.e-6

    def build():
        sim = Simulation(Nz, zmax, Nr, rmax, 2, zmax / Nz / c, n_order=16,
                         boundaries={"z": "periodic", "r": "open"},
                         n_damp={"z": 0, "r": 12}, random_seed=0,
                         verbose_level=0, **CPU)
        add_laser_pulse(sim, GaussianLaser(a0=0.01, waist=1.5e-6,
                                           tau=5.e-15, z0=6.e-6))
        return sim
    Ez1, Ez4, run = mesh_vs_single(build, 120,
                                   dict(correct_currents=False))
    assert run.states[0].spect.Ep_pml is not None
    assert rel(Ez1, Ez4) < 1e-6


def test_galilean_on_slabs_matches_single_card():
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    Nz, Nr, zmax, rmax = 128, 24, 12.8e-6, 8.e-6

    def build():
        sim = Simulation(Nz, zmax, Nr, rmax, 2, zmax / Nz / c, n_order=16,
                         v_comoving=0.9999 * c, use_galilean=True,
                         random_seed=0, verbose_level=0, **CPU)
        add_laser_pulse(sim, GaussianLaser(a0=0.01, waist=3.e-6,
                                           tau=6.e-15, z0=6.e-6))
        return sim
    Ez1, Ez4, _ = mesh_vs_single(build, 80, dict(correct_currents=False))
    assert rel(Ez1, Ez4) < 1e-6


def test_cubic_plasma_wave_on_slabs_matches_single_card():
    from fbpic_tpu_torch import Simulation
    Nz, Nr, zmax, rmax = 128, 16, 25.6e-6, 12.8e-6
    n_e, w0, eps = 2.e24, 5.e-6, 1e-3
    k0 = 2 * np.pi / zmax
    wp = np.sqrt(n_e * e**2 / (m_e * epsilon_0))

    def build():
        sim = Simulation(Nz, zmax, Nr, rmax, 2, zmax / Nz / c, 0., zmax, 0.,
                         0.9 * rmax, 2, 2, 4, n_e, n_order=16,
                         particle_shape="cubic", exchange_period=1,
                         random_seed=0, verbose_level=0, **CPU)
        v = sim.ptcl[0]
        x, y, z = v.x, v.y, v.z
        env = np.exp(-(x**2 + y**2) / w0**2)
        v.ux = eps * c / wp * 2 * x / w0**2 * env * np.sin(k0 * z)
        v.uy = eps * c / wp * 2 * y / w0**2 * env * np.sin(k0 * z)
        v.uz = -eps * c / wp * k0 * env * np.cos(k0 * z)
        v.inv_gamma = 1. / np.sqrt(1 + v.ux**2 + v.uy**2 + v.uz**2)
        return sim
    Ez1, Ez4, _ = mesh_vs_single(build, 30)
    assert rel(Ez1, Ez4) < 5e-3


def lwfa(exchange_period=1, antenna=False):
    """tests/test_multichip_diag.py's LWFA (laser direct or from an
    antenna at 6 um)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    nz, zmax, zmin = 130, 12.e-6, -4.e-6
    sim = Simulation(nz, zmax, 20, 10.e-6, 2, (zmax - zmin) / nz / c,
                     p_zmin=2.e-6, p_zmax=200.e-6, p_rmin=0., p_rmax=9.e-6,
                     p_nz=1, p_nr=2, p_nt=4, n_e=5.e24, zmin=zmin,
                     n_order=16, boundaries={"z": "open", "r": "reflective"},
                     exchange_period=exchange_period, random_seed=0,
                     verbose_level=0, **CPU)
    if antenna:
        z_ant = 6.e-6
        add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                           z0=z_ant - 3 * c * 8.e-15,
                                           zf=z_ant),
                        method="antenna", z0_antenna=z_ant)
    else:
        add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6, tau=8.e-15,
                                           z0=6.e-6))
    sim.set_moving_window(v=c)
    return sim


def _unique_live_ids(run, index):
    ids = np.concatenate([
        s.species[index].ids[s.species[index].w != 0].numpy()
        for s in run.states])
    assert len(np.unique(ids)) == len(ids), "duplicate ids across slabs"
    return ids


def jax_rank_draws(seed):
    """fbpic_tpu's draws of ionization on a mesh slab
    (core/step.py:92-109: the rank folded in last) as the port's draw
    source."""
    import jax
    import jax.numpy as jnp
    from types import SimpleNamespace
    from fbpic_tpu.core.step import _stream_key, _STREAM_IONIZE

    def draws(name, iteration, species_index, shape, dtype, rank=None):
        assert name == "ionize" and rank is not None
        st = SimpleNamespace(seed=jnp.asarray(seed, jnp.uint32),
                             iteration=jnp.asarray(iteration, jnp.int32))
        key = jax.random.fold_in(
            _stream_key(st, _STREAM_IONIZE, species_index), rank)
        return torch.as_tensor(np.array(jax.random.uniform(
            key, shape, jnp.float64)))
    return draws


def ionizing(pkg, **kw):
    """tests/test_multichip_processes.py's ionization setup."""
    import importlib
    mod = importlib.import_module(pkg)
    ext = importlib.import_module(pkg + ".lpa_utils.external_fields")
    Nz, zmax = 64, 6.4e-6
    sim = mod.Simulation(Nz, zmax, 8, 2.e-6, 1, zmax / Nz / c, n_order=16,
                         random_seed=3, verbose_level=0, **kw)
    atoms = sim.add_new_species(q=e, m=m_p, n=1e20, p_nz=2, p_nr=2, p_nt=4,
                                p_zmin=0, p_zmax=zmax, p_rmin=0,
                                p_rmax=1.5e-6, continuous_injection=False)
    elec = sim.add_new_species(q=-e, m=m_e, capacity=65536,
                               continuous_injection=False)
    atoms.make_ionizable("H", elec, level_start=0)
    elec.track()
    atoms.track()
    sim.external_fields.append(ext.ExternalField(
        lambda F, x, y, z, t, a, l: F + a, "Ex", 3.0e10, 0.0,
        species=atoms))
    return sim


def test_ionization_on_slabs_matches_fbpic_tpu_mesh():
    from fbpic_tpu.parallel.api import distribute_simulation as j_dist
    from fbpic_tpu_torch.parallel import distribute_simulation
    from fbpic_tpu_torch.utils.carry import join_words
    s0 = ionizing("fbpic_tpu")
    r0 = j_dist(s0, n_devices=N_DEV, correct_currents=False)
    r0.step(8)
    sim = ionizing("fbpic_tpu_torch", **CPU)
    sim.process_draws = jax_rank_draws(int(s0.state.seed))
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV,
                                correct_currents=False)
    run.step(8)
    for si in (0, 1):
        sp0 = r0.state.species[si]
        ref = {n: np.asarray(getattr(sp0, n)).reshape(N_DEV, -1)
               for n in ("x", "y", "z", "ux", "uy", "uz", "w")}
        ids = join_words(sp0.ids, sp0.ids_hi).reshape(N_DEV, -1)
        scales = {v: max(np.abs(ref[n]).max() for n in names) for v, names
                  in (("pos", "xyz"), ("mom", ("ux", "uy", "uz")))}
        for i, st in enumerate(run.states):
            sp = st.species[si]
            live = ref["w"][i] != 0
            np.testing.assert_array_equal(sp.w.numpy() != 0, live)
            np.testing.assert_array_equal(sp.ids.numpy()[live],
                                          ids[i][live].astype(np.int64))
            if si == 0:
                np.testing.assert_array_equal(
                    sp.ionization_level.numpy()[live], np.asarray(
                        sp0.ionization_level).reshape(N_DEV, -1)[i][live])
            for n in ("x", "y", "z", "ux", "uy", "uz", "w"):
                scale = (np.abs(ref["w"]).max() if n == "w"
                         else scales["pos" if n in "xyz" else "mom"])
                diff = getattr(sp, n).numpy()[live] - ref[n][i][live]
                if diff.size:
                    assert np.abs(diff).max() <= 1e-12 * scale, (si, i, n)
        assert int(run.states[0].species[si].next_id) == int(
            join_words(sp0.next_id, sp0.next_id_hi))
    assert sum(int((s.species[1].w != 0).sum()) for s in run.states) > 0


def test_ionization_on_slabs_keeps_ids_unique():
    """tests/test_multichip_processes.py: hydrogen atoms in a uniform
    Ex (an external field on the atoms), ionized into a tracked electron
    species on 4 slabs, three chunks of 4 steps."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.external_fields import ExternalField
    from fbpic_tpu_torch.parallel import distribute_simulation
    Nz, zmax = 64, 6.4e-6
    sim = Simulation(Nz, zmax, 8, 2.e-6, 1, zmax / Nz / c, n_order=16,
                     random_seed=3, verbose_level=0, **CPU)
    atoms = sim.add_new_species(q=e, m=m_p, n=1e20, p_nz=2, p_nr=2, p_nt=4,
                                p_zmin=0, p_zmax=zmax, p_rmin=0,
                                p_rmax=1.5e-6, continuous_injection=False)
    elec = sim.add_new_species(q=-e, m=m_e, capacity=65536,
                               continuous_injection=False)
    atoms.make_ionizable("H", elec, level_start=0)
    elec.track()
    atoms.track()
    sim.external_fields.append(ExternalField(
        lambda F, x, y, z, t, a, l: F + a, "Ex", 3.0e10, 0.0,
        species=atoms))
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV,
                                correct_currents=False)
    counts = []
    for _ in range(3):
        run.step(4)
        counts.append(sum(int((s.species[1].w != 0).sum())
                          for s in run.states))
    assert 0 < counts[0] < counts[-1]
    ids = _unique_live_ids(run, 1)
    assert len(ids) == counts[-1]
    n_ionized = sum(int(((s.species[0].w != 0)
                         & (s.species[0].ionization_level >= 1)).sum())
                    for s in run.states)
    assert counts[-1] == n_ionized
    # the replicated counter: one id per electron created on any slab
    assert all(int(s.species[1].next_id) == int(run.states[0].species[1]
                                                .next_id)
               for s in run.states)


def test_compton_on_slabs_counts_photons_with_unique_ids():
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.parallel import distribute_simulation
    Nz, zmax = 64, 6.4e-6
    sim = Simulation(Nz, zmax, 8, 2.e-6, 1, zmax / Nz / c, n_order=16,
                     random_seed=5, verbose_level=0, **CPU)
    elec = sim.add_new_species(q=-e, m=m_e, n=1e20, p_nz=2, p_nr=4, p_nt=4,
                               p_zmin=0, p_zmax=zmax, p_rmin=0,
                               p_rmax=1.5e-6, continuous_injection=False)
    photons = sim.add_new_species(q=0., m=0., capacity=65536,
                                  continuous_injection=False)
    elec.activate_compton(photons, laser_energy=1.0e6,
                          laser_wavelength=0.8e-6, laser_waist=1.0e-3,
                          laser_ctau=1.0e-2, laser_initial_z0=0.0)
    photons.track()
    run = distribute_simulation(sim, devices=["cpu"] * N_DEV,
                                correct_currents=False)
    counts = []
    for _ in range(3):
        run.step(4)
        counts.append(sum(int((s.species[1].w != 0).sum())
                          for s in run.states))
    assert 0 < counts[0] < counts[-1]
    assert len(_unique_live_ids(run, 1)) == counts[-1]

"""Diagnostics, checkpoints and the back-transformed field capture on a
decomposed run: the port on 4 CPU slabs against the port on one device
(float64), at fbpic_tpu's tolerances (tests/test_multichip_diag.py).

- the field and particle diagnostics every 25 steps and a checkpoint
  every 25 on the LWFA, written through ``sync_to_sim``: the files of
  iterations 0, 25 and 50 exist, Ez within 5e-3 of the single card's,
  rho within 1e-10 at 0 and within 5e-3 on every row at 25 and 50 (the
  record sums each slab's rho_prev over the halo: the rows next to a
  slab seam included), the particle weight totals within 1e-9; a restart from the decomposed
  checkpoint at 25, decomposed again and run on to 50, matches the
  uninterrupted run within 1e-8;
- a laser emitted by an antenna on the LWFA: Ez within 1e-2 (fbpic_tpu's
  gate: the correction's locality amplified by the antenna's surface
  current);
- the exchange period: the clamp max(1, int((g/2 - 3) / (2 c dt / dz)))
  and the migration buffer default, and exchange_period 4 on the LWFA
  (migration, removal, injection and fresh rho_prev every 4 steps):
  5e-3;
- the back-transformed field diagnostic (gamma 5, five snapshots
  sweeping a periodic box): each slab slices the interior it owns and
  the slices are summed over the slabs (fbpic_tpu's device_capture on
  the mesh); the same cells filled as on one device, every field within
  1e-6 of the snapshot's Er scale.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from fbpic_tpu.constants import c  # noqa: E402
from test_torch_parallel_configs import lwfa, mesh_vs_single  # noqa: E402

N_DEV = 4


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


def rel(a, b):
    assert np.abs(a).max() > 0
    return np.abs(a - b).max() / np.abs(a).max()


def test_diagnostics_and_checkpoint_on_slabs(tmp_path):
    from fbpic_tpu_torch.diagnostics import FieldDiagnostic, ParticleDiagnostic
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        set_periodic_checkpoint, restart_from_checkpoint)
    from fbpic_tpu_torch.parallel import distribute_simulation
    n_steps = 50
    dirs = {k: str(tmp_path / k) for k in ("single", "multi", "ckpt")}

    def with_diags(sim, wdir):
        sim.diags = [FieldDiagnostic(25, sim=sim, write_dir=wdir),
                     ParticleDiagnostic(25, species={"electrons": sim.ptcl[0]},
                                        sim=sim, write_dir=wdir)]
        return sim
    single = with_diags(lwfa(), dirs["single"])
    single.step(n_steps)
    sim4 = with_diags(lwfa(), dirs["multi"])
    set_periodic_checkpoint(sim4, 25, checkpoint_dir=dirs["ckpt"])
    run = distribute_simulation(sim4, devices=["cpu"] * N_DEV)
    run.step(n_steps)
    assert sorted(os.listdir(dirs["ckpt"])) == [
        "checkpoint_00000025.pt", "checkpoint_00000050.pt"]
    # the record's z rows within 8 cells of a slab seam: the deposit's
    # reach (the linear shape's cell and the binomial filter's) and the
    # window's shift of rho_prev; with each slab's own rho_prev as the
    # record, the rows 1-4 cells below the seams were off by up to 0.7
    # of the largest |rho|; the record summed over the halo holds them
    rows = np.arange(single.Nz_phys) + single.nd_edge
    seams = run.Nz_int * np.arange(1, N_DEV)
    near_seam = np.abs(rows[:, None] - seams).min(axis=1) < 8
    assert 0 < near_seam.sum() < len(rows) / 2
    for it in (0, 25, 50):
        p1 = os.path.join(dirs["single"], "hdf5", "data%08d.h5" % it)
        p4 = os.path.join(dirs["multi"], "hdf5", "data%08d.h5" % it)
        with h5py.File(p1, "r") as f1, h5py.File(p4, "r") as f4:
            ds = "data/%d/fields/E/z" % it
            Ez1, Ez4 = f1[ds][...], f4[ds][...]
            scale = np.abs(Ez1).max()
            assert scale > 0
            assert np.abs(Ez4 - Ez1).max() / scale < 5e-3, it
            # rho: at 0 the single card's deposit cut into slabs; then
            # each slab's own deposit summed over the halo, on every row
            ds = "data/%d/fields/rho" % it
            rho1, rho4 = f1[ds][...], f4[ds][...]
            diff = np.abs(rho4 - rho1).max(axis=(0, 1)) / np.abs(rho1).max()
            if it == 0:
                assert diff.max() <= 1e-10
            else:
                assert diff[near_seam].max() < 5e-3, it
                assert diff.max() < 5e-3, it
            w1 = f1["data/%d/particles/electrons/weighting" % it][...].sum()
            w4 = f4["data/%d/particles/electrons/weighting" % it][...].sum()
            assert abs(w4 - w1) / w1 < 1e-9, it

    sim_r = lwfa()
    restart_from_checkpoint(sim_r, iteration=25, checkpoint_dir=dirs["ckpt"])
    assert sim_r.iteration == 25
    run_r = distribute_simulation(sim_r, devices=["cpu"] * N_DEV)
    run_r.step(n_steps - 25)
    run_r.sync_to_sim()
    run.sync_to_sim()
    Ez_cont, Ez_rest = ez_full(sim4), ez_full(sim_r)
    assert np.abs(Ez_rest - Ez_cont).max() <= 1e-8 * np.abs(Ez_cont).max()


def test_back_transformed_fields_on_slabs_match_single_card(tmp_path):
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.diagnostics import BackTransformedFieldDiagnostic
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    from fbpic_tpu_torch.parallel import distribute_simulation
    Nz, Nr, Nm, zmax, rmax = 128, 16, 2, 12.8e-6, 8.e-6
    gamma_b = 5.0
    beta_b = np.sqrt(1 - 1 / gamma_b**2)
    n_steps = 40

    def build(wdir):
        sim = Simulation(Nz, zmax, Nr, rmax, Nm, zmax / Nz / c, n_order=16,
                         random_seed=0, verbose_level=0, device="cpu",
                         dtype=torch.float64)
        add_laser_pulse(sim, GaussianLaser(a0=0.01, waist=3.e-6, tau=6.e-15,
                                           z0=6.e-6))
        # snapshot plane i sweeps back through the box and leaves it at
        # t_b = i beta zmax / (7 c): spread over the run
        diag = BackTransformedFieldDiagnostic(
            0.0, gamma_b * zmax, 0.0, gamma_b * beta_b * zmax / (7 * c), 5,
            gamma_b, sim=sim, write_dir=wdir)
        sim.diags = [diag]
        return sim, diag

    sim1, diag1 = build(str(tmp_path / "one"))
    sim1.step(n_steps, correct_currents=False)
    sim4, diag4 = build(str(tmp_path / "four"))
    run = distribute_simulation(sim4, devices=["cpu"] * N_DEV,
                                correct_currents=False)
    run.step(n_steps)
    n_filled = 0
    for s1, s4 in zip(diag1.snapshots, diag4.snapshots):
        np.testing.assert_array_equal(s1.filled, s4.filled)
        n_filled += int(s1.filled.sum())
        if not s1.filled.any():
            continue
        scale = max(np.abs(s1.data["Er"]).max(), 1e-30)
        for name in s1.names:
            d1 = s1.data[name][:, s1.filled, :]
            d4 = s4.data[name][:, s4.filled, :]
            assert np.abs(d4 - d1).max() <= 1e-6 * scale, name
    assert n_filled > 0, "no snapshot plane crossed the box"


def test_antenna_on_slabs_matches_single_card():
    Ez1, Ez4, run = mesh_vs_single(lambda: lwfa(antenna=True), 50)
    assert rel(Ez1, Ez4) < 1e-2
    assert run.overflow_totals["migration_overflow"] == 0


def test_exchange_period_clamp_and_exchange_period_4():
    from fbpic_tpu_torch.parallel import domain as pdom, distribute_simulation
    sim = lwfa(exchange_period=4)
    # the clamp: 2 c dt / dz = 2 cells a step
    for g, want in ((24, 4), (12, 1), (8, 1), (40, 4), (63, 4)):
        assert pdom.clamped_exchange_period(sim.config, g, 4) == want
        assert pdom.clamped_exchange_period(sim.config, g, 100) == max(
            1, int((g / 2 - 3) / 2))
    for g in (8, 24):
        run = distribute_simulation(lwfa(exchange_period=4),
                                    devices=["cpu"] * N_DEV, n_guard=g)
        assert run.exchange_period == pdom.clamped_exchange_period(
            sim.config, g, 4)
        occ = max(sc.sort_K for sc in sim.species_configs)
        assert run.migration_buffer == max(
            2048, (run.exchange_period + 1) * max(occ, 256))
    Ez1, Ez4, run = mesh_vs_single(lambda: lwfa(exchange_period=4), 50,
                                   n_guard=24)
    assert run.exchange_period == 4
    assert rel(Ez1, Ez4) < 5e-3

"""Checkpoint / restart of fbpic_tpu_torch.

- Within the port, on tests/test_torch_ring.py's window configuration
  with tracking on and thermal momenta (continuous injection draws
  column angles and momenta from ``sim.generator`` on every exchange):
  a run checkpointed at iteration 8 and continued to 16, against a
  second simulation restarted from that file (its generator advanced
  first, so only the checkpoint can give it the right state) and
  stepped to 16 with the same calls.  Every tensor must be equal bit
  for bit -- fields, particles, Kahan words and ids -- and every host
  value too (iteration, time, zmin, mw_zref, next_free, inj_z_end,
  next_id, sort_K, overflow totals).  float32 runs the resident layout
  (Kahan words), float64 a ring.
- From an fbpic_tpu checkpoint: fbpic_tpu writes its HDF5 checkpoint at
  iteration 8 and runs on to 12; the port takes the checkpoint's named
  leaves through ``utils.carry.state_from_leaves`` and steps to 12 with
  fbpic_tpu's injection angles.  Held at tests/test_torch_step.py's
  tolerances (particles 1e-12, fields 1e-8 of their vector's scale;
  counters, grid edge and time exactly), ids exactly on the live slots.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from fbpic_tpu.constants import c  # noqa: E402

THERMAL = dict(ux_th=0.01, uy_th=0.01, uz_th=0.01)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port_sim(dtype):
    from test_torch_ring import (NZ_PHYS, ZMAX, NR, RMAX, NM, DT, SIM_KW,
                                 SPECIES_KW, LASER_KW)
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    sim = Simulation(NZ_PHYS, ZMAX, NR, RMAX, NM, DT, device="cpu",
                     dtype=dtype, **SIM_KW)
    sim.add_new_species(**SPECIES_KW, **THERMAL)
    add_laser_pulse(sim, GaussianLaser(**LASER_KW))
    sim.set_moving_window(v=c)
    sim.ptcl[0].track()
    return sim


def _assert_same(sim_a, sim_b):
    from fbpic_tpu_torch.diagnostics.checkpoint_restart import (
        checkpoint_dict)
    a, b = checkpoint_dict(sim_a), checkpoint_dict(sim_b)
    assert a["host"] == b["host"]
    assert sorted(a["tensors"]) == sorted(b["tensors"])
    for key, t in a["tensors"].items():
        assert t.dtype == b["tensors"][key].dtype, key
        assert torch.equal(t, b["tensors"][key]), key
    assert sim_a.species_configs == sim_b.species_configs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restart_is_bit_exact(dtype, tmp_path):
    from fbpic_tpu_torch.diagnostics import (set_periodic_checkpoint,
                                             restart_from_checkpoint)
    cdir = str(tmp_path / "checkpoints")
    run = _port_sim(dtype)
    assert run.species_configs[0].resident == (dtype == torch.float32)
    set_periodic_checkpoint(run, 8, checkpoint_dir=cdir)
    run.step(8)
    assert os.listdir(cdir) == ["checkpoint_00000008.pt"]
    run.step(8)
    assert sorted(os.listdir(cdir)) == ["checkpoint_%08d.pt" % i
                                        for i in (8, 16)]
    sp = run.state.species[0]
    assert sp.next_id > sp.capacity and (sp.comp_x is not None) == (
        dtype == torch.float32)

    again = _port_sim(dtype)
    torch.rand(100, generator=again.generator)   # another generator state
    restart_from_checkpoint(again, iteration=8, checkpoint_dir=cdir)
    assert again.iteration == 8
    again.step(8)
    _assert_same(run, again)


def test_restart_from_fbpic_tpu_checkpoint(tmp_path):
    from fbpic_tpu.diagnostics import set_periodic_checkpoint
    from fbpic_tpu_torch.utils.carry import state_from_leaves
    from test_torch_ring import window_sims, compare_states
    from test_torch_step import jax_state_to_numpy
    from test_torch_tracking import jax_ids
    s0, s1 = window_sims()
    for s in (s0, s1):
        s.ptcl[0].track()
    cdir = str(tmp_path / "checkpoints")
    set_periodic_checkpoint(s0, 8, checkpoint_dir=cdir)
    s0.step(8, show_progress=False)
    s0.step(4, show_progress=False)
    with h5py.File(os.path.join(cdir, "checkpoint_%08d.h5" % 8), "r") as f:
        leaves = {f[k].attrs["keypath"]: f[k][...] for k in f}
    assert ".species[0].ids_hi" in leaves and ".spect.Ep.re" in leaves
    s1.state = state_from_leaves(leaves, device="cpu")
    assert s1.iteration == 8
    s1.step(4)
    compare_states(jax_state_to_numpy(s0.state), s1.state)
    sp0, sp1 = s0.state.species[0], s1.state.species[0]
    live = np.asarray(sp0.w) != 0
    np.testing.assert_array_equal(jax_ids(sp0)[live],
                                  sp1.ids.numpy()[live].astype(np.uint64))
    assert sp1.next_id == int(sp0.next_id) + (int(sp0.next_id_hi) << 32)

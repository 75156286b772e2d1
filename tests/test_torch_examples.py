"""The published example scripts run through fbpic_tpu_torch (CPU).

Each script's text is read and only ``fbpic_tpu`` is changed to
``fbpic_tpu_torch``; it runs in its smoke mode
(``FBPIC_TPU_EXAMPLE_SMOKE=1``, as tests/test_examples.py runs it for
fbpic_tpu) with ``fbpic_tpu_torch.Simulation`` bound to
``device="cpu"`` (the port's default is the card), in a temporary
directory.  examples/ is not edited.

- lwfa_script.py: tracking, the field and particle diagnostics every 4
  steps and a checkpoint at 8, in 10 steps: the files of iterations 0,
  4 and 8, the checkpoint, unique ids in the particle records;
- boosted_frame_script.py: the back-transformed field diagnostic over
  8 steps of the boosted frame;
- ionization_script.py: He electrons and an N5+ dopant made ionizable
  into a tracked species, its field and particle diagnostics every 4
  steps, 8 steps: the files of iterations 0, 4 and 8, the ionizer's
  configuration, and that every electron the dopant lost was created
  (ids unique);
- multichip_lwfa_script.py: ``distribute_simulation`` bound to
  ``devices=["cpu"] * 4`` (the port's default is every CUDA device), 6
  steps on 4 slabs with the field diagnostic every 4 steps: the files of
  iterations 0 and 4, and the live particles of the slabs the
  Simulation's after the last gather.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def run_example(script, tmp_path, monkeypatch):
    """Run the example's text through the port; its globals."""
    import fbpic_tpu_torch
    import fbpic_tpu_torch.parallel.api as api
    monkeypatch.setattr(api, "distribute_simulation", functools.partial(
        api.distribute_simulation, devices=["cpu"] * 4))
    with open(os.path.join(EXAMPLES, script)) as f:
        text = f.read().replace("fbpic_tpu", "fbpic_tpu_torch")
    monkeypatch.setenv("FBPIC_TPU_EXAMPLE_SMOKE", "1")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(fbpic_tpu_torch, "Simulation", functools.partial(
        fbpic_tpu_torch.Simulation, device="cpu"))
    namespace = {"__name__": "__main__"}
    exec(compile(text, script, "exec"), namespace)
    return namespace


def test_lwfa_script_runs_through_the_port(tmp_path, monkeypatch):
    ns = run_example("lwfa_script.py", tmp_path, monkeypatch)
    sim = ns["sim"]
    assert sim.iteration == 10 and sim.device.type == "cpu"
    hdf5 = tmp_path / "diags" / "hdf5"
    assert sorted(os.listdir(hdf5)) == ["data%08d.h5" % i for i in (0, 4, 8)]
    assert os.listdir(tmp_path / "checkpoints") == ["checkpoint_00000008.pt"]
    with h5py.File(hdf5 / "data00000008.h5", "r") as f:
        assert "E" in f["/data/8/fields"] and "rho" in f["/data/8/fields"]
        sp = f["/data/8/particles/electrons"]
        n = sp["weighting"].shape[0]
    live = sim.state.species[0].w != 0
    ids = sim.state.species[0].ids[live]
    assert int((ids == 0).sum()) == 0
    assert len(torch.unique(ids)) == int(live.sum())
    assert n <= int(live.sum())


def test_boosted_frame_script_runs_through_the_port(tmp_path, monkeypatch):
    ns = run_example("boosted_frame_script.py", tmp_path, monkeypatch)
    sim = ns["sim"]
    assert sim.iteration == ns["N_step"] and sim.device.type == "cpu"
    btd, = sim.diags
    assert type(btd).__module__ == "fbpic_tpu_torch.diagnostics.boosted_diag"
    assert len(btd.snapshots) == ns["NSNAP"] and btd._buf is None


def test_ionization_script_runs_through_the_port(tmp_path, monkeypatch):
    ns = run_example("ionization_script.py", tmp_path, monkeypatch)
    sim = ns["sim"]
    assert sim.iteration == ns["N_step"] and sim.device.type == "cpu"
    hdf5 = tmp_path / "diags" / "hdf5"
    assert sorted(os.listdir(hdf5)) == ["data%08d.h5" % i for i in (0, 4, 8)]
    ion, elec = ns["ion"]._index, ns["elec_from_N"]._index
    cfg = sim.species_configs[ion].ionizer
    assert (cfg.element, cfg.level_start, cfg.level_max,
            cfg.target_index) == ("N", 5, 7, elec)
    sp_i, sp_e = sim.state.species[ion], sim.state.species[elec]
    live = sp_i.w != 0
    gained = int((sp_i.ionization_level[live] - 5).sum())
    born = sp_e.w != 0
    assert int(born.sum()) == gained
    ids = sp_e.ids[born]
    assert int((ids == 0).sum()) == 0 and len(torch.unique(ids)) == gained


def test_multichip_lwfa_script_runs_through_the_port(tmp_path, monkeypatch):
    ns = run_example("multichip_lwfa_script.py", tmp_path, monkeypatch)
    run, sim = ns["run"], ns["sim"]
    assert run.iteration == ns["N_step"] and run.ndev == 4
    assert all(s.iteration == ns["N_step"] for s in run.states)
    assert all(d.type == "cpu" for d in run.devices)
    hdf5 = tmp_path / "diags" / "hdf5"
    assert sorted(os.listdir(hdf5)) == ["data%08d.h5" % i for i in (0, 4)]
    with h5py.File(hdf5 / "data00000004.h5", "r") as f:
        assert "E" in f["/data/4/fields"]
    assert run.overflow_totals["migration_overflow"] == 0
    run.sync_to_sim()
    assert sim.iteration == ns["N_step"]
    assert sim.ptcl[0].Ntot == sum(int((s.species[0].w != 0).sum())
                                   for s in run.states)

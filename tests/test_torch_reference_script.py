"""FBPIC's documented LWFA script through fbpic_tpu_torch (CPU).

tests/test_reference_script.py runs the reference's documented LWFA
script (reduced) through fbpic_tpu: ``fbpic_tpu.main.Simulation`` with
``use_cuda``, a ``dens_func``, tracking, the field and particle
diagnostics, ``set_periodic_checkpoint`` and
``restart_from_checkpoint``.  Here that file's text is read and only
``fbpic_tpu`` is changed to ``fbpic_tpu_torch``, with
``fbpic_tpu_torch.main.Simulation`` bound to ``device="cpu"`` (the
port's default is the card) and ``dtype=torch.float64`` (the precision
that file runs fbpic_tpu in, under tests/conftest.py; in float32 a
restart moves the fields by ~3e-6 relative, because the restarted run's
first step() call re-deposits rho_prev and refreshes the spectral E / B
where the uninterrupted run carries them), and the file's own test runs
as written: 32 steps with checkpoints at 16 and 32,
a restart, and the records at iteration 30 equal at the original's 1e-8.
That restart takes the latest checkpoint (32) and never rewrites
iteration 30, in both packages, so the check compares a file with
itself; this test then removes the checkpoint at 32 and restarts again,
from 16 to 32 (a new step() call at 16), and holds the records at 20
and 30 against the uninterrupted run's at the original's 1e-8.  tests/ is read, not edited.

Also: ``use_cuda`` and ``use_all_mpi_ranks`` are accepted and change
nothing on the CPU (``device`` decides), and ``device="cuda"`` without
CUDA raises, whatever ``use_cuda`` says.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

SCRIPT = os.path.join(os.path.dirname(__file__), "test_reference_script.py")
#: The script's grid (tests/test_reference_script.py:28-30)
GRID = (120, 9.e-6, 20, 10.e-6, 2, 1.e-15)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_reference_script_restart_through_the_port(tmp_path, monkeypatch):
    import fbpic_tpu_torch
    import fbpic_tpu_torch.main
    with open(SCRIPT) as f:
        text = f.read().replace("fbpic_tpu", "fbpic_tpu_torch")
    made = []

    def on_cpu(*args, **kwargs):
        sim = fbpic_tpu_torch.Simulation(*args, device="cpu",
                                         dtype=torch.float64, **kwargs)
        made.append(sim)
        return sim

    monkeypatch.setattr(fbpic_tpu_torch.main, "Simulation", on_cpu)
    namespace = {"__name__": "reference_script"}
    exec(compile(text, SCRIPT, "exec"), namespace)
    assert namespace["use_cuda"] is True
    namespace["test_reference_lwfa_script_restart"](tmp_path)
    original, restarted = made
    for sim in made:
        assert sim.device.type == "cpu" and sim.dtype == torch.float64
        assert sim.task_device is None
    assert original.iteration == 32 and restarted.iteration == 48
    wdir = str(tmp_path / "diags")
    assert sorted(f for f in os.listdir(wdir) if f.startswith("check")) \
        == ["checkpoint_00000016.pt", "checkpoint_00000032.pt"]
    original = {it: _records(wdir, it) for it in (20, 30)}
    os.remove(os.path.join(wdir, "checkpoint_00000032.pt"))
    restarted = namespace["run"](16, use_restart=True, wdir=wdir,
                                 save_checkpoints=False)
    assert restarted.iteration == 32
    for it, recs in original.items():
        again = _records(wdir, it)
        for name, ref in recs.items():
            scale = np.abs(ref).max()
            assert scale > 0, name
            assert np.abs(again[name] - ref).max() <= 1e-8 * scale, name


def _records(wdir, it):
    """E_z and rho of the field diagnostic's file at iteration it."""
    import h5py
    with h5py.File(os.path.join(wdir, "hdf5", "data%08d.h5" % it), "r") as f:
        return {n: f["/data/%d/fields/%s" % (it, n)][:]
                for n in ("E/z", "rho")}


@pytest.mark.parametrize("use_cuda,use_all_mpi_ranks", [
    (True, True), (True, False), (False, False)])
def test_use_cuda_and_all_ranks_are_accepted(use_cuda, use_all_mpi_ranks):
    """The arguments fbpic_tpu takes; on the CPU the run stays where
    device= puts it."""
    from fbpic_tpu_torch.main import Simulation
    sim = Simulation(*GRID, use_cuda=use_cuda,
                     use_all_mpi_ranks=use_all_mpi_ranks, device="cpu",
                     verbose_level=0)
    assert sim.device == torch.device("cpu") and sim.task_device is None
    assert sim.use_all_devices is use_all_mpi_ranks
    sim.step(1)
    assert sim.state.interp.Ez.device.type == "cpu"


@pytest.mark.parametrize("use_cuda", [True, False])
def test_cuda_device_raises_without_cuda(use_cuda):
    """device="cuda" (the default) without CUDA is an error, never a
    quiet CPU run, whatever use_cuda says."""
    from fbpic_tpu_torch.main import Simulation
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(*GRID, use_cuda=use_cuda)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(*GRID, use_cuda=use_cuda, use_all_mpi_ranks=False,
                   device="cuda")

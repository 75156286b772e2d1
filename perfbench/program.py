"""The system under test, fbpic_tpu_torch: the one module of the
benchmark that imports it.  What the benchmark takes from it: the
entries the window drives (``Simulation.step``, and
``parallel.distribute_simulation(sim).step`` for slabs) and, through
runner.py, their state, counters and graph variants, and through the
profiler its kernels' names."""
from types import SimpleNamespace

PACKAGE = "fbpic_tpu_torch"


def api():
    """The program's API namespace for a configuration's builder."""
    import fbpic_tpu_torch
    from fbpic_tpu_torch import constants
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, GaussianLaser
    from fbpic_tpu_torch.parallel import distribute_simulation
    return SimpleNamespace(
        Simulation=fbpic_tpu_torch.Simulation,
        BoostConverter=fbpic_tpu_torch.BoostConverter,
        add_laser_pulse=add_laser_pulse, GaussianLaser=GaussianLaser,
        distribute_simulation=distribute_simulation,
        constants=constants, package=PACKAGE)

"""The plain reference of the benchmark's configurations.

``plain_pic`` is a frozen copy of fbpic_tpu_torch's plain PyTorch paths
(no CUDA kernel, no CUDA graph); it imports nothing of fbpic_tpu_torch,
jax or fbpic_tpu, and works out again everything the program derives
from the configuration."""
from types import SimpleNamespace

PACKAGE = __name__ + ".plain_pic"


def api():
    """The reference's API namespace for a configuration's builder."""
    from . import plain_pic
    return SimpleNamespace(
        Simulation=plain_pic.Simulation, BoostConverter=plain_pic.BoostConverter,
        add_laser_pulse=plain_pic.add_laser_pulse,
        GaussianLaser=plain_pic.GaussianLaser,
        distribute_simulation=plain_pic.distribute_simulation,
        constants=plain_pic.constants, package=PACKAGE)

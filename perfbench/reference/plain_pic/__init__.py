"""A frozen copy of fbpic_tpu_torch's plain PyTorch paths, the plain
reference of the benchmark's LWFA configurations.

Copied from fbpic_tpu_torch 0.1.0 and changed only so that it stands
alone: the three hand-written CUDA kernels' wrappers (particles/cuda_*.py)
keep their plain versions alone and run them on every device,
``Simulation.step`` runs the eager step loop, never CUDA graphs
(core/simulation.py), a decomposed run builds no kernel
(parallel/api.py) and keeps all its slabs on one card, where they
exchange tensors by reference (parallel/group.py); the reference sets
its ``eager``.  core/graph.py, parallel/peer.py and utils/kernels.py
come along only because the modules that import them do: nothing of
the reference calls them.  One departure, where the program departs from
FBPIC: the end of a species' injected plasma moves with the plasma
between injections (FBPIC's ContinuousInjector advances
``z_end_plasma`` by ``v_end_plasma`` every step; core/step.py), and one
exchange period may inject the columns that the window and the moving
plasma end uncover together (``max_cols`` in core/simulation.py).  The
program keeps the front where its last column was injected, so a plasma
streaming against the window (a boosted frame) is injected with holes.
A plasma at rest (v_end_plasma = 0) is injected alike by both.
"""

__version__ = "0.1.0-plain-reference"

from .core.simulation import Simulation  # noqa: E402
from .lpa_utils.boosted_frame import BoostConverter  # noqa: E402
from .lpa_utils.laser import add_laser_pulse, GaussianLaser  # noqa: E402
from .parallel import distribute_simulation  # noqa: E402
from . import constants  # noqa: E402

__all__ = ["BoostConverter", "GaussianLaser", "Simulation", "add_laser_pulse",
           "constants", "distribute_simulation", "__version__"]

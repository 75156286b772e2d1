"""
fbpic_tpu_torch: the spectral quasi-3D Particle-In-Cell framework of
fbpic_tpu, ported to PyTorch and hand-written CUDA kernels for one
NVIDIA H100.

fbpic_tpu (JAX) stays the reference: the port keeps its module tree,
names and array layouts (fields (Nm, Nz, Nr), the sorted particle
layout (Nz, K)), and its tests hold each module against the JAX
function on the same inputs.  Plain tensor work is PyTorch; the two
kernels of the main path -- the fused J + d(rho) deposit and the sorted
field gather -- are CUDA C++ kernels (csrc/), built with nvcc at first
use.  Simulations run on an explicit ``device``/``dtype`` (default
CUDA, float32).
"""

__version__ = "0.1.0"

from .core.simulation import Simulation  # noqa: E402
from .fields.smoothing import BinomialSmoother  # noqa: E402
from .lpa_utils.boosted_frame import BoostConverter  # noqa: E402

__all__ = ["BinomialSmoother", "BoostConverter", "Simulation", "__version__"]

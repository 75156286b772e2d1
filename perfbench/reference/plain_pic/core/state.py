"""The simulation state that flows through the step."""
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..fields.solver import SpectralFields, InterpFields
from ..particles.state import ParticleState


@dataclass
class SimState:
    """Full simulation state: fields + particles + scalars.

    The scalars ``time``, ``zmin`` and ``mw_zref`` are numpy scalars of
    the working dtype: the host computes the moving-window shift and
    the injection front from them without a device round trip, with the
    same rounding as fbpic_tpu's device scalars.
    """
    spect: SpectralFields
    interp: InterpFields
    species: List[ParticleState]
    time: np.floating
    zmin: np.floating
    iteration: int
    # Moving-window reference position (None = no window)
    mw_zref: np.floating = None
    # Running count of particle-steps that exceeded a z column's slot
    # capacity sort_K (int64 device scalar)
    sort_overflow: torch.Tensor = None
    # Running count of injected particles that found no free slot
    ring_overwrite: torch.Tensor = None
    # z-decomposed runs (parallel/): running count of the particles a
    # migration buffer or a slab's dead slots could not take
    migration_overflow: torch.Tensor = None

"""Mirrors: zero the E/B fields inside a thin z-slab every step.

Behavioral reference: FBPIC's fbpic/lpa_utils/mirrors.py.  The zeroing
is diagonal in z, so the step applies it together with the open-z
damping, as one multiplicative z profile in partial-interpolation space
(core/step.py::damp_EB_z).
"""
import numpy as np

from ..constants import c


class Mirror(object):
    """Reflective slab: fields are set to 0 over n_cells starting at z_lab.

    Parameters
    ----------
    z_lab: float -- position of the mirror (lab frame)
    n_cells: int -- thickness of the zeroed slab in cells
    gamma_boost: float or None -- boost of the simulation frame
    m: 'all', an int or a list of modes (the modes the mirror zeroes)
    """

    def __init__(self, z_lab, n_cells=2, gamma_boost=None, m="all"):
        self.z_lab = z_lab
        self.n_cells = n_cells
        self.gamma_boost = gamma_boost
        self.m = m

    def z_boost_and_beta(self):
        """Return (z0, v) such that the mirror is at z0 + v*t in the
        simulation frame."""
        if self.gamma_boost is None:
            return self.z_lab, 0.0
        beta0 = np.sqrt(1.0 - 1.0 / self.gamma_boost**2)
        return self.z_lab / self.gamma_boost, -beta0 * c

"""Binomial smoothing of charge/current, applied as a k-space filter.

Behavioral reference: FBPIC's fbpic/fields/smoothing.py.
"""
import numpy as np


class BinomialSmoother:
    """n-pass binomial filter with optional compensator, per axis."""

    def __init__(self, n_passes=1, compensator=False):
        if isinstance(n_passes, int):
            self.n_passes = {"z": n_passes, "r": n_passes}
        elif isinstance(n_passes, dict):
            self.n_passes = n_passes
        else:
            raise ValueError("Invalid argument `n_passes`")

        if isinstance(compensator, bool):
            self.compensator = {"z": compensator, "r": compensator}
        elif isinstance(compensator, dict):
            self.compensator = compensator
        else:
            raise ValueError("Invalid argument `compensator`")

    def get_filter_array(self, kz, kr, dz, dr):
        """Return (filt_z (Nz,), filt_r (..Nr,)) multiplying fields in k-space.

        `kz` is the *true* kz (not the finite-order modified one), so the
        filter acts on the actual high frequencies.
        """
        sz2 = np.sin(0.5 * kz * dz) ** 2
        nz = self.n_passes["z"]
        filt_z = (1.0 - sz2) ** nz
        if self.compensator["z"]:
            filt_z *= 1.0 + nz * sz2

        sr2 = np.sin(0.5 * kr * dr) ** 2
        nr = self.n_passes["r"]
        filt_r = (1.0 - sr2) ** nr
        if self.compensator["r"]:
            filt_r *= 1.0 + nr * sr2

        return filt_z, filt_r

"""Grid geometry and radial deposition coefficients.

Host-side precomputation (numpy float64) of:
  - cell volumes, with the m=0 "modified volume" correction that makes a
    uniform charge distribution exactly uniform in spectral space
    (reference: FBPIC's fbpic/fields/interpolation_grid.py:83-100)
  - Ruyten-corrected shape factor coefficients, which make a uniform
    distribution of macroparticles deposit a uniform rho on the grid
    (Ruyten JCP 105 (1993); reference: interpolation_grid.py:102-138)
"""
import numpy as np
from scipy.special import j1, jn_zeros

from .hankel import dht_matrices


def cell_volumes(Nz_global_dz, Nr, rmax, use_modified_volume=True):
    """Return (vol_m0, vol_higher): two (Nr,) arrays of cell volumes.

    `Nz_global_dz` is dz (the z cell size).  vol_higher is the standard
    ring volume; vol_m0 includes the Hankel-consistent correction.
    """
    dz = Nz_global_dz
    dr = rmax / Nr
    nr_vals = np.arange(Nr)

    r = (0.5 + nr_vals) * dr
    vol_standard = np.pi * dz * ((r + 0.5 * dr) ** 2 - (r - 0.5 * dr) ** 2)

    if use_modified_volume:
        alphas = jn_zeros(0, Nr)
        M, _, _ = dht_matrices(0, 0, Nr, rmax)
        vol_m0 = dz * np.array(
            [(M[nr, :] * 2.0 / (alphas * j1(alphas))).sum() for nr in nr_vals]
        )
    else:
        vol_m0 = vol_standard

    return vol_m0, vol_standard


def ruyten_coefficients(vol, Nr, dr, dz, use_ruyten_shapes=True):
    """Ruyten shape-factor coefficients beta_n for one mode's cell volume.

    Returns (linear_coef, cubic_coef), each (Nr+1,) with a prepended 0
    used by particles in the first half-cell (see reference
    interpolation_grid.py:120-138 for why that entry is 0).
    """
    nr_vals = np.arange(Nr)
    if use_ruyten_shapes:
        norm_vol = vol / (2 * np.pi * dr**2 * dz)
        linear = 6.0 / (nr_vals + 1) * (
            np.cumsum(norm_vol) - 0.5 * (nr_vals + 1.0) ** 2 - 1.0 / 24
        )
        cubic = 6.0 / (nr_vals + 1) * (
            np.cumsum(norm_vol) - 0.5 * (nr_vals + 1.0) ** 2 - 1.0 / 8
        )
        cubic[0] = 6.0 * (norm_vol[0] - 0.5 - 239.0 / (15 * 2**7))
    else:
        linear = np.zeros(Nr)
        cubic = np.zeros(Nr)

    linear = np.concatenate((np.array([0.0]), linear))
    cubic = np.concatenate((np.array([0.0]), cubic))
    return linear, cubic

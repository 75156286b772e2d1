"""Finite-order spectral stencil utilities (host-side, numpy float64).

A finite-order modified [kz] localizes the otherwise-global PSATD
operator along z, so that multi-chip z-slab decomposition only needs
~2*n_order guard cells.

Attribution: the stencil recurrence and cutoff constants are derived
from FBPIC (fields/utility_methods.py:11-185), Copyright 2016-2018
FBPIC contributors (University of Hamburg / LBNL), 3-Clause-BSD-LBNL
license (math: Vincenti & Vay, CPC 2016).  This is a reformatted
transcription of that implementation, not an independent derivation.
"""
import numpy as np

from ..constants import c


def get_modified_k(k, n_order, dz):
    """Modified [k] = sum_n a_n sin(n k dz) / (n dz) for an order-n stencil.

    n_order = -1 means infinite order (returns k unchanged); otherwise
    n_order must be a positive even integer.
    """
    if n_order == -1:
        return k
    if n_order % 2 == 1 or n_order <= 0:
        raise ValueError("Invalid n_order: %d" % n_order)
    m = n_order // 2

    # Stencil coefficients a_n by recurrence: a_n = -((m+1-n)/(m+n)) a_{n-1}
    stencil_coef = np.zeros(m + 1)
    stencil_coef[0] = -2.0
    for n in range(1, m + 1):
        stencil_coef[n] = -(m + 1 - n) * 1.0 / (m + n) * stencil_coef[n - 1]

    n_array = np.arange(1, m + 1)
    sin_array = np.sin(k[:, np.newaxis] * n_array[np.newaxis, :] * dz) / (
        n_array[np.newaxis, :] * dz
    )
    return np.tensordot(sin_array, stencil_coef[1:], axes=(-1, -1))


def stencil_reach(kz, kperp, cdt, v_comoving, use_galilean):
    """Spatial reach (cells) of the PSATD propagator for modified kz."""
    k = np.sqrt(kz**2 + kperp**2)
    if use_galilean and v_comoving is not None:
        abs_v = np.abs(v_comoving)
        theta = np.exp(1.0j * abs_v * kz * cdt / c / 2)
    else:
        theta = np.ones_like(kz, dtype=complex)
    cos_stencil = np.fft.ifft(theta**2 * np.cos(k * cdt))
    sin_z_stencil = np.fft.ifft(
        np.where(k == 0, kz, theta**2 * np.sin(k * cdt) / k * kz)
    )
    sin_perp_stencil = np.fft.ifft(
        np.where(k == 0, kperp, theta**2 * np.sin(k * cdt) / k * kperp)
    )
    alpha = np.sqrt(
        np.abs(cos_stencil) ** 2
        + np.abs(sin_z_stencil) ** 2
        + np.abs(sin_perp_stencil) ** 2
    )
    half = np.abs(alpha)[: int(alpha.shape[0] / 2)]
    idx = np.where(half < 1.0e-16)[0]
    if len(idx) == 0:
        # Stencil never decays to machine precision within the box
        # (infinite-order solver): reach is the whole half-box.
        return int(half.shape[0])
    return int(idx[0])


def get_stencil_reach(Nz, dz, cdt, n_order, v_comoving=None, use_galilean=False):
    """Stencil reach for a grid of Nz cells, spacing dz, at kperp=0.5."""
    real_kz = 2 * np.pi * np.fft.fftfreq(Nz, d=dz)
    kz = get_modified_k(real_kz, n_order, dz=dz)
    return stencil_reach(kz, 0.5, cdt, v_comoving, use_galilean)

"""Quasi Discrete Hankel Transform (DHT) for the Fourier-Bessel solver.

The radial transform of azimuthal mode ``m`` uses Hankel transforms of
order p in {m-1, m, m+1}: the scalar (z) components use p=m, while the
transverse (+/-) combinations use p=m+1 / p=m-1.  Each transform is a
dense (Nr, Nr) matrix product - on TPU this is a batched MXU matmul.

Matrix construction runs on the *host* in numpy float64 (matrix
pseudo-inversion is numerically delicate) and is cast to the device
dtype on transfer.  Math follows the FBPIC paper; behavioral reference:
FBPIC's fbpic/fields/spectral_transform/hankel.py:74-122.

Transform convention (matrices stored transposed so that the transform
is ``F @ M``):
    spectral  = interp  @ M        (forward, "transform")
    interp    = spectral @ invM    (backward, "inverse_transform")
"""
import numpy as np
from scipy.special import jn, jn_zeros


def dht_matrices(p: int, m: int, Nr: int, rmax: float):
    """Build (M, invM, nu) for a quasi-DHT of order p, azimuthal mode m.

    Returns
    -------
    M : (Nr, Nr) float64 ndarray -- forward transform matrix (transposed form)
    invM : (Nr, Nr) float64 ndarray -- inverse transform matrix
    nu : (Nr,) float64 ndarray -- spectral grid (kr = 2*pi*nu)
    """
    if m not in (p - 1, p, p + 1):
        raise ValueError("m must be either p-1, p or p+1")

    # Zeros of the Bessel function of order m. For m != 0, nu=0 is included
    # as an extra (evanescent-like) mode needed to represent fields on axis.
    if m != 0:
        alphas = np.hstack((np.array([0.0]), jn_zeros(m, Nr - 1)))
    else:
        alphas = jn_zeros(m, Nr)

    # Spectral grid and uniform half-offset radial grid
    nu = 1.0 / (2 * np.pi * rmax) * alphas
    r = (rmax / Nr) * (np.arange(Nr) + 0.5)

    # Inverse matrix from the Bessel-mode expansion
    invM = np.empty((Nr, Nr))
    p_denom = p + 1 if p == m else p
    denom = np.pi * rmax**2 * jn(p_denom, alphas) ** 2
    num = jn(p, 2 * np.pi * r[np.newaxis, :] * nu[:, np.newaxis])
    if m != 0:
        invM[1:, :] = num[1:, :] / denom[1:, np.newaxis]
        if p == m - 1:
            # Extra kperp=0 mode; normalization chosen for conditioning
            invM[0, :] = r ** (m - 1) * 1.0 / (np.pi * rmax ** (m + 1))
        else:
            invM[0, :] = 0.0
    else:
        invM[:, :] = num[:, :] / denom[:, np.newaxis]

    # Forward matrix by (pseudo-)inversion
    M = np.empty((Nr, Nr))
    if m != 0 and p != m - 1:
        M[:, 1:] = np.linalg.pinv(invM[1:, :])
        M[:, 0] = 0.0
    else:
        M = np.linalg.inv(invM)

    return M, invM, nu


def build_mode_matrices(Nm: int, Nr: int, rmax: float):
    """Build stacked DHT matrices for all azimuthal modes 0..Nm-1.

    Returns a dict of numpy float64 arrays, each of shape (Nm, Nr, Nr):
      M0/invM0   : p = m   (scalar z-components and rho)
      Mp/invMp   : p = m+1 (the '+' transverse combination)
      Mm/invMm   : p = m-1 (the '-' transverse combination)
    plus 'kr': (Nm, Nr) radial wavevectors (from the p=m transform) and
    'nu0': (Nm, Nr).
    """
    out = {k: np.zeros((Nm, Nr, Nr)) for k in
           ("M0", "invM0", "Mp", "invMp", "Mm", "invMm")}
    kr = np.zeros((Nm, Nr))
    for m in range(Nm):
        M, invM, nu = dht_matrices(m, m, Nr, rmax)
        out["M0"][m], out["invM0"][m] = M, invM
        kr[m] = 2 * np.pi * nu
        M, invM, _ = dht_matrices(m + 1, m, Nr, rmax)
        out["Mp"][m], out["invMp"][m] = M, invM
        M, invM, _ = dht_matrices(m - 1, m, Nr, rmax)
        out["Mm"][m], out["invMm"][m] = M, invM
    out["kr"] = kr
    return out

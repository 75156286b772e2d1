"""PSATD (Pseudo-Spectral Analytic Time Domain) coefficients.

Precomputed on the host in numpy float64 and stacked over azimuthal
modes into ``(Nm, Nz, Nr)`` arrays, then cast to the device dtype.
Supports the standard scheme and the Galilean / comoving scheme (the
NCI-free boosted-frame solver).

Math reference: Lehe et al. CPC 2016; Kirchen/Lehe 2016 (Galilean).

Attribution: the coefficient formulas here (including the omega -> 0
limit handling and variable naming) are derived from FBPIC
(fields/psatd_coefs.py:55-163), Copyright 2016-2018 FBPIC
contributors (University of Hamburg / LBNL), 3-Clause-BSD-LBNL
license.  They are restructured for batched (Nm, Nz, Nr) host
precomputation but are a transcription of that implementation, not an
independent derivation.
"""
import numpy as np

from ..constants import c, mu_0, epsilon_0


class PsatdCoeffs:
    """Stacked PSATD coefficients for all modes.

    Attributes (numpy arrays of shape (Nm, Nz, Nr)):
      C, S_w, j_coef, rho_prev_coef, rho_next_coef  -- real
      T_eb, T_cc, T_rho, j_corr_coef                -- complex
                                      (only when V is not None)
    """

    def __init__(self, kz, kr, dt, V=None, use_galilean=False):
        """
        Parameters
        ----------
        kz: (Nm, Nz, Nr) or broadcastable float64 array (modified kz mesh)
        kr: (Nm, Nz, Nr) or broadcastable float64 array
        dt: float
        V: float or None -- comoving current velocity
        use_galilean: bool -- Galilean frame (vs comoving-current scheme)
        """
        i = 1.0j
        self.dt = dt
        self.V = V
        inv_dt = 1.0 / dt

        kz, kr = np.broadcast_arrays(kz, kr)

        w = c * np.sqrt(kz**2 + kr**2)
        inv_w = 1.0 / np.where(w == 0, 1.0, w)

        self.C = np.cos(w * dt)
        self.S_w = np.sin(w * dt) * inv_w
        self.S_w[w == 0] = dt

        if V is not None:
            T2 = np.exp(i * kz * V * dt)
            if not use_galilean:
                T = np.exp(i * 0.5 * kz * V * dt)
            if use_galilean:
                self.T_eb = T2
                self.T_cc = np.ones_like(T2)
            else:
                self.T_cc = T
                self.T_eb = np.ones_like(T2)

            if V != 0.0:
                i_kz_V = i * kz * V
                i_kz_V[kz == 0] = 1.0
                self.T_rho = np.where(
                    kz == 0.0, -dt, (1.0 - T2) / (self.T_cc * i_kz_V)
                )
            else:
                self.T_rho = -dt * np.ones_like(kz, dtype=complex)

            if V != 0.0:
                inv_w_kzV = 1.0 / np.where(
                    (w**2 - kz**2 * V**2) == 0, 1.0, (w**2 - kz**2 * V**2)
                )
                inv_1_T2 = 1.0 / np.where(T2 == 1, 1.0, 1 - T2)
                xi_1 = (
                    1.0 / self.T_cc * inv_w_kzV
                    * (1.0 - T2 * self.C + i * kz * V * T2 * self.S_w)
                )
                xi_2 = np.where(
                    kz != 0,
                    inv_w_kzV
                    * (
                        1.0
                        + i * kz * V * T2 * self.S_w * inv_1_T2
                        + kz**2 * V**2 * inv_w**2 * T2 * inv_1_T2 * (1 - self.C)
                    ),
                    1.0 * inv_w**2 * (1.0 - self.S_w * inv_dt),
                )
                xi_3 = np.where(
                    kz != 0,
                    self.T_eb
                    * inv_w_kzV
                    * (
                        self.C
                        + i * kz * V * T2 * self.S_w * inv_1_T2
                        + kz**2 * V**2 * inv_w**2 * inv_1_T2 * (1 - self.C)
                    ),
                    1.0 * inv_w**2 * (self.C - self.S_w * inv_dt),
                )

            if V != 0:
                self.j_corr_coef = np.where(
                    kz != 0, (-i * kz * V) * inv_1_T2, inv_dt
                )
            else:
                self.j_corr_coef = inv_dt * np.ones_like(kz, dtype=complex)

        # j_coef for the Maxwell push
        if V is None or V == 0:
            self.j_coef = mu_0 * c**2 * (1.0 - self.C) * inv_w**2
        else:
            self.j_coef = mu_0 * c**2 * xi_1
        self.j_coef[w == 0] = mu_0 * c**2 * (0.5 * dt**2)

        if V is None or V == 0:
            self.rho_prev_coef = (
                c**2 / epsilon_0 * (self.C - inv_dt * self.S_w) * inv_w**2
            )
        else:
            self.rho_prev_coef = c**2 / epsilon_0 * xi_3
        self.rho_prev_coef[w == 0] = c**2 / epsilon_0 * (-1.0 / 3 * dt**2)

        if V is None or V == 0:
            self.rho_next_coef = (
                c**2 / epsilon_0 * (1 - inv_dt * self.S_w) * inv_w**2
            )
        else:
            self.rho_next_coef = c**2 / epsilon_0 * xi_2
        self.rho_next_coef[w == 0] = c**2 / epsilon_0 * (1.0 / 6 * dt**2)

"""Host-side (numpy float64) spectral transforms.

Used by one-off global solves at initialization time -- laser direct
injection and space-charge fields -- where float64 accuracy matters and
the work happens once (reference: lpa_utils/laser/direct_injection.py
and lpa_utils/bunch.py:838-976 perform these as rank-0 global solves).
"""
import numpy as np

from .hankel import build_mode_matrices
from .stencil import get_modified_k


class HostSpectralTransformer:
    """Numpy float64 interp<->spect transforms for all modes."""

    def __init__(self, Nz, Nr, Nm, rmax, dz, n_order=-1):
        self.Nz, self.Nr, self.Nm = Nz, Nr, Nm
        self.mats = build_mode_matrices(Nm, Nr, rmax)
        self.kr = self.mats["kr"]                      # (Nm, Nr)
        self.kz_true = 2 * np.pi * np.fft.fftfreq(Nz, dz)
        self.kz = get_modified_k(self.kz_true, n_order, dz)

    def interp2spect_scal(self, F):
        """F: (Nm, Nz, Nr) complex -> spectral (Nm, Nz, Nr)."""
        G = np.fft.fft(F, axis=1)
        return np.einsum("mzr,mrs->mzs", G, self.mats["M0"])

    def spect2interp_scal(self, G):
        F = np.einsum("mzr,mrs->mzs", G, self.mats["invM0"])
        return np.fft.ifft(F, axis=1)

    def interp2spect_vect(self, Fr, Ft):
        fr = np.fft.fft(Fr, axis=1)
        ft = np.fft.fft(Ft, axis=1)
        p = 0.5 * (fr - 1j * ft)
        m = 0.5 * (fr + 1j * ft)
        Gp = np.einsum("mzr,mrs->mzs", p, self.mats["Mp"])
        Gm = np.einsum("mzr,mrs->mzs", m, self.mats["Mm"])
        return Gp, Gm

    def spect2interp_vect(self, Gp, Gm):
        p = np.einsum("mzr,mrs->mzs", Gp, self.mats["invMp"])
        m = np.einsum("mzr,mrs->mzs", Gm, self.mats["invMm"])
        Fr = p + m
        Ft = 1j * (p - m)
        return np.fft.ifft(Fr, axis=1), np.fft.ifft(Ft, axis=1)

    def kz_kr_mesh(self):
        """Return (kz, kr) meshes of shape (Nm, Nz, Nr) (modified kz)."""
        kz = np.broadcast_to(self.kz[None, :, None],
                             (self.Nm, self.Nz, self.Nr))
        kr = np.broadcast_to(self.kr[:, None, :],
                             (self.Nm, self.Nz, self.Nr))
        return kz, kr

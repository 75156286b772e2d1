"""Interpolation-grid <-> spectral-grid transforms, batched over modes.

Fields are complex tensors of shape (Nm, Nz, Nr).  The longitudinal
transform is ``torch.fft`` along z with numpy's convention (forward
unnormalized, inverse 1/Nz); the radial quasi-DHT is a batched matmul
against the per-mode (Nr, Nr) matrices of ``hankel.py``.

Transform composition (reference: spectral_transformer.py:89-223):
  scalar  interp->spect : FFT(z) then  G = F @ M0
  scalar  spect->interp : F = G @ invM0  then IFFT(z)
  vector  interp->spect : FFT both, (r,t)->(p,m), p @ Mp, m @ Mm
  vector  spect->interp : p @ invMp, m @ invMm, (p,m)->(r,t), IFFT both

The source transforms must be float32-exact: TF32-level error in the
mode-0 charge/current is amplified by the 1/k^2 current correction into
spurious fields.  The E/B transforms run in full float32 too.
"""
from dataclasses import dataclass

import torch

from .hankel import build_mode_matrices

# Full-precision float32 matmuls everywhere (DHT, skinny damping).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass
class TransformMatrices:
    """Real DHT matrices stacked over modes, (Nm, Nr, Nr) each."""
    M0: torch.Tensor
    invM0: torch.Tensor
    Mp: torch.Tensor
    invMp: torch.Tensor
    Mm: torch.Tensor
    invMm: torch.Tensor
    kr: torch.Tensor      # (Nm, Nr)

    @staticmethod
    def build(Nm, Nr, rmax, device, dtype):
        mats = build_mode_matrices(Nm, Nr, rmax)
        return TransformMatrices(**{
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in mats.items()})


def dht(M, F):
    """Batched radial transform: out[m, z, s] = sum_r F[m, z, r] M[m, r, s]
    (M real, so the complex transform is two real matmuls)."""
    return torch.complex(torch.matmul(F.real, M), torch.matmul(F.imag, M))


def fft_z(F):
    """Forward DFT along z (axis -2), unnormalized (numpy convention)."""
    return torch.fft.fft(F, dim=-2)


def ifft_z(F):
    """Inverse DFT along z (axis -2), 1/Nz normalized."""
    return torch.fft.ifft(F, dim=-2)


def rt_to_pm(Fr, Ft):
    """(r, t) -> (+, -) spectral combination."""
    return 0.5 * (Fr - 1j * Ft), 0.5 * (Fr + 1j * Ft)


def pm_to_rt(Fp, Fm):
    """(+, -) -> (r, t) combination."""
    return Fp + Fm, 1j * (Fp - Fm)


def interp2spect_scal(mats, F):
    return dht(mats.M0, fft_z(F))


def spect2interp_scal(mats, G):
    return ifft_z(dht(mats.invM0, G))


def interp2spect_vect(mats, Fr, Ft):
    p, m = rt_to_pm(fft_z(Fr), fft_z(Ft))
    return dht(mats.Mp, p), dht(mats.Mm, m)


def spect2interp_vect(mats, Gp, Gm):
    Fr, Ft = pm_to_rt(dht(mats.invMp, Gp), dht(mats.invMm, Gm))
    return ifft_z(Fr), ifft_z(Ft)


def spect2partial_interp(mats, G):
    """z-only inverse transform (partial interpolation space)."""
    return ifft_z(G)


def partial_interp2spect(mats, F):
    """z-only forward transform (partial interpolation space)."""
    return fft_z(F)


def spect2interp_EB_fields(mats, Ep, Em, Ez, Bp, Bm, Bz):
    """spect->interp for all 6 E/B components."""
    Er, Et = spect2interp_vect(mats, Ep, Em)
    Br, Bt = spect2interp_vect(mats, Bp, Bm)
    return (Er, Et, spect2interp_scal(mats, Ez),
            Br, Bt, spect2interp_scal(mats, Bz))


def interp2spect_EB_fields(mats, Er, Et, Ez, Br, Bt, Bz):
    """interp->spect for all 6 E/B components."""
    Ep, Em = interp2spect_vect(mats, Er, Et)
    Bp, Bm = interp2spect_vect(mats, Br, Bt)
    return (Ep, Em, interp2spect_scal(mats, Ez),
            Bp, Bm, interp2spect_scal(mats, Bz))


def interp2spect_J_fields(mats, Jr, Jt, Jz):
    """interp->spect for the three current components."""
    Jp, Jm = interp2spect_vect(mats, Jr, Jt)
    return Jp, Jm, interp2spect_scal(mats, Jz)

"""The spectral field solver: state containers + precomputed operator data.

`FieldAux` bundles every precomputed array the solver needs (transform
matrices, PSATD coefficients, filters, volumes); it is built once on the
host in float64 and cast to the working dtype on the working device.
`SpectralFields` and `InterpFields` are the per-step field state:
complex tensors stacked over modes as (Nm, Nz, Nr).

Structural reference: FBPIC's fbpic/fields/fields.py (the Fields
container).
"""
from dataclasses import dataclass, fields as dc_fields
from typing import Optional

import numpy as np
import torch

from .transform import TransformMatrices
from .hankel import build_mode_matrices
from .psatd_coefs import PsatdCoeffs
from .stencil import get_modified_k
from .smoothing import BinomialSmoother
from .grids import cell_volumes, ruyten_coefficients


def complex_dtype(dtype):
    """The complex dtype matching a real working dtype."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


@dataclass(frozen=True)
class GridConfig:
    """Static grid configuration of the (single-device) domain."""
    Nz: int
    Nr: int
    Nm: int
    dz: float
    dr: float
    rmax: float
    dt: float
    n_order: int = -1
    current_correction: str = "curl-free"
    particle_shape: str = "linear"
    boundaries_z: str = "periodic"  # 'periodic' or 'open'
    # Open-z boundary cell accounting (0 for periodic); Nz INCLUDES
    # 2*(n_guard + nz_damp + n_inject) extra cells
    # (reference: boundary_communicator.py:224-278)
    n_guard: int = 0
    nz_damp: int = 0
    n_inject: int = 0

    @property
    def nd_edge(self):
        """Total guard+damp+inject cells at each z edge."""
        return self.n_guard + self.nz_damp + self.n_inject


@dataclass
class SpectralFields:
    """Spectral-space field state, complex (Nm, Nz, Nr) each."""
    Ep: torch.Tensor
    Em: torch.Tensor
    Ez: torch.Tensor
    Bp: torch.Tensor
    Bm: torch.Tensor
    Bz: torch.Tensor
    Jp: torch.Tensor
    Jm: torch.Tensor
    Jz: torch.Tensor
    rho_prev: torch.Tensor
    rho_next: torch.Tensor

    @staticmethod
    def zeros(config, device, dtype):
        shape = (config.Nm, config.Nz, config.Nr)
        cdt = complex_dtype(dtype)
        return SpectralFields(**{
            f.name: torch.zeros(shape, dtype=cdt, device=device)
            for f in dc_fields(SpectralFields)})


@dataclass
class InterpFields:
    """Real-space (interpolation grid) E/B state used by the field gather,
    complex (Nm, Nz, Nr) each."""
    Er: torch.Tensor
    Et: torch.Tensor
    Ez: torch.Tensor
    Br: torch.Tensor
    Bt: torch.Tensor
    Bz: torch.Tensor

    @staticmethod
    def zeros(config, device, dtype):
        shape = (config.Nm, config.Nz, config.Nr)
        cdt = complex_dtype(dtype)
        return InterpFields(**{
            f.name: torch.zeros(shape, dtype=cdt, device=device)
            for f in dc_fields(InterpFields)})


@dataclass
class FieldAux:
    """Precomputed arrays for the spectral solver (built once)."""
    mats: TransformMatrices
    kz_true: torch.Tensor    # (Nz,) real, FFT-convention kz
    kz: torch.Tensor         # (1, Nz, 1) modified kz (finite-order stencil)
    kr: torch.Tensor         # (Nm, 1, Nr)
    # PSATD coefficients, (Nm, Nz, Nr):
    C: torch.Tensor
    S_w: torch.Tensor
    j_coef: torch.Tensor
    rho_prev_coef: torch.Tensor
    rho_next_coef: torch.Tensor
    # Current correction: 1/k^2, 0 at k=0, (Nm, Nz, Nr)
    inv_k2: torch.Tensor
    # Source smoothing filter:
    filter_z: torch.Tensor   # (Nz,)
    filter_r: torch.Tensor   # (Nm, Nr)
    # Deposition normalization:
    invvol: torch.Tensor     # (Nm, Nr) inverse cell volume
    ruyten_linear: torch.Tensor  # (2, Nr+1): [mode 0, modes > 0]
    # Open-z damping profile (None for periodic z):
    damp_z: Optional[torch.Tensor] = None        # (Nz,) multiplicative
    # Skinny spectral damping correction (open z): the z profile differs
    # from 1 only on the guard/damp rows, so damping = spect -
    # Wf[:, rows] (1-prof)[rows] ifft[rows] -- one (Nz, nrows) matmul
    # instead of a full z round trip.
    damp_rows: Optional[torch.Tensor] = None     # (nrows,) int64
    damp_skinny: Optional[torch.Tensor] = None   # (Nz, nrows) complex


def build_field_aux(config: GridConfig, smoother: BinomialSmoother = None,
                    use_ruyten_shapes=True, use_modified_volume=True,
                    device="cpu", dtype=torch.float64) -> FieldAux:
    """Host-side construction of all solver coefficient arrays."""
    Nz, Nr, Nm = config.Nz, config.Nr, config.Nm
    if smoother is None:
        smoother = BinomialSmoother(n_passes=1, compensator=False)

    mats_np = build_mode_matrices(Nm, Nr, config.rmax)
    kr_np = mats_np["kr"]  # (Nm, Nr)

    kz_true = 2 * np.pi * np.fft.fftfreq(Nz, config.dz)
    kz_mod = get_modified_k(kz_true, config.n_order, config.dz)

    kz_mesh = np.broadcast_to(kz_mod[None, :, None], (Nm, Nz, Nr))
    kr_mesh = np.broadcast_to(kr_np[:, None, :], (Nm, Nz, Nr))
    ps = PsatdCoeffs(kz_mesh.copy(), kr_mesh.copy(), config.dt,
                     V=None, use_galilean=False)

    k2 = kz_mesh**2 + kr_mesh**2
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))

    filter_z, _ = smoother.get_filter_array(
        kz_true, kr_np[0], config.dz, config.dr)
    filter_r = np.stack(
        [smoother.get_filter_array(kz_true, kr_np[m], config.dz,
                                   config.dr)[1] for m in range(Nm)])

    vol_m0, vol_std = cell_volumes(config.dz, Nr, config.rmax,
                                   use_modified_volume=use_modified_volume)
    invvol = np.stack([1.0 / vol_m0] + [1.0 / vol_std] * max(Nm - 1, 0))[:Nm]
    ruyt_lin0, _ = ruyten_coefficients(
        vol_m0, Nr, config.dr, config.dz, use_ruyten_shapes)
    ruyt_lin1, _ = ruyten_coefficients(
        vol_std, Nr, config.dr, config.dz, use_ruyten_shapes)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    damp = {}
    if config.boundaries_z == "open" and config.nz_damp > 0:
        prof = _damp_profile_z(config)
        damp["damp_z"] = dev(prof)
        rows = np.nonzero(prof != 1.0)[0]
        if rows.size:
            k = np.arange(Nz)
            Wf_rows = np.exp(-2j * np.pi * np.outer(k, rows) / Nz)
            damp["damp_rows"] = torch.as_tensor(rows, device=device)
            damp["damp_skinny"] = torch.as_tensor(
                Wf_rows * (1.0 - prof[rows])[None, :],
                dtype=complex_dtype(dtype), device=device)

    return FieldAux(
        mats=TransformMatrices.build(Nm, Nr, config.rmax, device, dtype),
        kz_true=dev(kz_true),
        kz=dev(kz_mod[None, :, None]),
        kr=dev(kr_np[:, None, :]),
        C=dev(ps.C), S_w=dev(ps.S_w), j_coef=dev(ps.j_coef),
        rho_prev_coef=dev(ps.rho_prev_coef),
        rho_next_coef=dev(ps.rho_next_coef),
        inv_k2=dev(inv_k2),
        filter_z=dev(filter_z), filter_r=dev(filter_r),
        invvol=dev(invvol),
        ruyten_linear=dev(np.stack([ruyt_lin0, ruyt_lin1])),
        **damp,
    )


def _damp_profile_z(config: GridConfig):
    """Full-grid multiplicative damping profile for open z boundaries.

    sin^2 ramp over nz_damp cells, zero over the guard+injection cells,
    at both ends (reference: boundary_communicator.py:909-945).
    """
    n_guard, nz_damp, n_inject = (config.n_guard, config.nz_damp,
                                  config.n_inject)
    nd = config.nd_edge
    i_cell = np.arange(nd)
    ramp = np.where(
        i_cell < n_guard + n_inject + nz_damp / 2.0,
        np.sin((i_cell - (n_guard + n_inject)) * np.pi / nz_damp) ** 2,
        1.0,
    )
    ramp = np.where(i_cell < n_guard + n_inject, 0.0, ramp)
    profile = np.ones(config.Nz)
    profile[:nd] = ramp
    profile[config.Nz - nd:] = ramp[::-1]
    return profile

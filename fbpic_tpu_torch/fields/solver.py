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

from ..constants import c
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
    # Galilean / comoving PSATD: the velocity the scheme follows (None =
    # standard scheme); use_galilean: the grid itself flows at v_comoving
    v_comoving: Optional[float] = None
    use_galilean: bool = True
    # Radial PML (boundaries r = 'open'): split fields, and nr_damp
    # damping cells INSIDE Nr (reference: pml_damping.py)
    use_pml: bool = False
    current_correction: str = "curl-free"
    particle_shape: str = "linear"
    boundaries_z: str = "periodic"  # 'periodic' or 'open'
    # Open-z boundary cell accounting (0 for periodic); Nz INCLUDES
    # 2*(n_guard + nz_damp + n_inject) extra cells
    # (reference: boundary_communicator.py:224-278)
    n_guard: int = 0
    nz_damp: int = 0
    n_inject: int = 0
    nr_damp: int = 0      # radial PML cells (0 unless use_pml)

    @property
    def use_comoving(self):
        return self.v_comoving is not None

    @property
    def v_galilean(self):
        """Speed at which the grid itself flows (0 unless Galilean)."""
        return (self.v_comoving if self.use_comoving and self.use_galilean
                else 0.0)

    @property
    def resort_band(self):
        """Columns a particle can cross in one step relative to the
        (possibly flowing) grid: the banded re-sort's band."""
        return max(1, int((c + abs(self.v_galilean)) * self.dt / self.dz
                          - 1e-9) + 1)

    @property
    def nd_edge(self):
        """Total guard+damp+inject cells at each z edge."""
        return self.n_guard + self.nz_damp + self.n_inject


#: Optional fields of SpectralFields / InterpFields (None unless the
#: configuration needs them)
CROSS_FIELDS = ("rho_next_z", "rho_next_xy")
SPECT_PML_FIELDS = ("Ep_pml", "Em_pml", "Bp_pml", "Bm_pml")
INTERP_PML_FIELDS = ("Er_pml", "Et_pml", "Br_pml", "Bt_pml")


def _zeros(cls, names, config, device, dtype):
    shape = (config.Nm, config.Nz, config.Nr)
    cdt = complex_dtype(dtype)
    return cls(**{n: torch.zeros(shape, dtype=cdt, device=device)
                  for n in names})


def present_fields(fields):
    """Names of the fields a SpectralFields / InterpFields holds (its
    optional ones only where allocated)."""
    return [f.name for f in dc_fields(fields)
            if getattr(fields, f.name) is not None]


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
    # Cross-deposition extras (current_correction = 'cross-deposition')
    rho_next_z: Optional[torch.Tensor] = None
    rho_next_xy: Optional[torch.Tensor] = None
    # Radial-PML split fields (use_pml)
    Ep_pml: Optional[torch.Tensor] = None
    Em_pml: Optional[torch.Tensor] = None
    Bp_pml: Optional[torch.Tensor] = None
    Bm_pml: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(config, device, dtype):
        names = [f.name for f in dc_fields(SpectralFields)
                 if f.name not in CROSS_FIELDS + SPECT_PML_FIELDS]
        if config.current_correction == "cross-deposition":
            names += CROSS_FIELDS
        if config.use_pml:
            names += SPECT_PML_FIELDS
        return _zeros(SpectralFields, names, config, device, dtype)


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
    Er_pml: Optional[torch.Tensor] = None
    Et_pml: Optional[torch.Tensor] = None
    Br_pml: Optional[torch.Tensor] = None
    Bt_pml: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(config, device, dtype):
        names = ["Er", "Et", "Ez", "Br", "Bt", "Bz"]
        if config.use_pml:
            names += INTERP_PML_FIELDS
        return _zeros(InterpFields, names, config, device, dtype)


@dataclass
class FieldAux:
    """Precomputed arrays for the spectral solver (built once)."""
    mats: TransformMatrices
    kz_true: torch.Tensor    # (Nz,) real, FFT-convention kz
    kz: torch.Tensor         # (1, Nz, 1) modified kz (finite-order stencil)
    kr: torch.Tensor         # (Nm, 1, Nr)
    # PSATD coefficients, (Nm, Nz, Nr); j_coef and the rho_*_coef are
    # complex in the Galilean/comoving scheme, real otherwise:
    C: torch.Tensor
    S_w: torch.Tensor
    j_coef: torch.Tensor
    rho_prev_coef: torch.Tensor
    rho_next_coef: torch.Tensor
    # Galilean/comoving extras, complex (None for the standard scheme):
    T_eb: Optional[torch.Tensor]
    T_cc: Optional[torch.Tensor]
    T_rho: Optional[torch.Tensor]
    j_corr_coef: Optional[torch.Tensor]
    # Current correction: 1/k^2, 0 at k=0, (Nm, Nz, Nr)
    inv_k2: torch.Tensor
    # Source smoothing filter:
    filter_z: torch.Tensor   # (Nz,)
    filter_r: torch.Tensor   # (Nm, Nr)
    # Deposition normalization:
    invvol: torch.Tensor     # (Nm, Nr) inverse cell volume
    ruyten_linear: torch.Tensor  # (2, Nr+1): [mode 0, modes > 0]
    ruyten_cubic: torch.Tensor   # (2, Nr+1)
    # Open-z damping profile (None for periodic z):
    damp_z: Optional[torch.Tensor] = None        # (Nz,) multiplicative
    # Radial PML damping profile (None unless use_pml):
    damp_r_pml: Optional[torch.Tensor] = None    # (Nr,) 1 outside the PML
    # Skinny spectral damping correction (open z): the z profile differs
    # from 1 only on the guard/damp rows, so damping = spect -
    # Wf[:, rows] (1-prof)[rows] ifft[rows] -- one (Nz, nrows) matmul
    # instead of a full z round trip.
    damp_rows: Optional[torch.Tensor] = None     # (nrows,) int64
    damp_skinny: Optional[torch.Tensor] = None   # (Nz, nrows) complex


def build_field_aux(config: GridConfig, smoother: BinomialSmoother = None,
                    use_ruyten_shapes=True, use_modified_volume=True,
                    *, device, dtype=torch.float64) -> FieldAux:
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
                     V=config.v_comoving, use_galilean=config.use_galilean)

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
    ruyt_lin0, ruyt_cub0 = ruyten_coefficients(
        vol_m0, Nr, config.dr, config.dz, use_ruyten_shapes)
    ruyt_lin1, ruyt_cub1 = ruyten_coefficients(
        vol_std, Nr, config.dr, config.dz, use_ruyten_shapes)

    def dev(x):
        """Real arrays in the working dtype, complex ones in its complex
        counterpart."""
        x = np.asarray(x)
        return torch.as_tensor(x, device=device, dtype=(
            complex_dtype(dtype) if np.iscomplexobj(x) else dtype))

    comoving = config.use_comoving

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
    if config.use_pml and config.nr_damp > 0:
        damp["damp_r_pml"] = dev(_pml_damp_profile_r(config))

    return FieldAux(
        mats=TransformMatrices.build(Nm, Nr, config.rmax, device, dtype),
        kz_true=dev(kz_true),
        kz=dev(kz_mod[None, :, None]),
        kr=dev(kr_np[:, None, :]),
        C=dev(ps.C), S_w=dev(ps.S_w), j_coef=dev(ps.j_coef),
        rho_prev_coef=dev(ps.rho_prev_coef),
        rho_next_coef=dev(ps.rho_next_coef),
        T_eb=dev(ps.T_eb) if comoving else None,
        T_cc=dev(ps.T_cc) if comoving else None,
        T_rho=dev(ps.T_rho) if comoving else None,
        j_corr_coef=dev(ps.j_corr_coef) if comoving else None,
        inv_k2=dev(inv_k2),
        filter_z=dev(filter_z), filter_r=dev(filter_r),
        invvol=dev(invvol),
        ruyten_linear=dev(np.stack([ruyt_lin0, ruyt_lin1])),
        ruyten_cubic=dev(np.stack([ruyt_cub0, ruyt_cub1])),
        **damp,
    )


def _pml_damp_profile_r(config: GridConfig):
    """Radial PML damping: exp(-4 (c dt/dr) x^2) over the last nr_damp
    cells, 1 elsewhere (reference: pml_damping.py:86-110)."""
    n_pml = config.nr_damp
    x_pml = np.arange(n_pml) / n_pml
    ramp = np.exp(-4.0 * (c * config.dt / config.dr) * x_pml**2)
    profile = np.ones(config.Nr)
    profile[config.Nr - n_pml:] = ramp
    return profile


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

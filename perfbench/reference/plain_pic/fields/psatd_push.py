"""PSATD field advance, curl-free current correction and source filters.

Field arrays are complex tensors stacked over azimuthal modes,
(Nm, Nz, Nr); the radial-PML split fields (``*_pml``) too.  Coefficient arrays are real, except those of the
Galilean / comoving scheme (T_eb, T_cc, T_rho, j_corr_coef and its
j_coef / rho_*_coef), which are complex tensors of the fields' complex
dtype.  Each function is the elementwise k-space update of the spectral
solver.  Behavioral reference: FBPIC's fbpic/fields/
numba_methods.py:64-382.
"""
import torch

from ..constants import c2, mu_0, epsilon_0


def push_eb_standard(
    Ep, Em, Ez, Bp, Bm, Bz, Jp, Jm, Jz, rho_prev, rho_next,
    rho_prev_coef, rho_next_coef, j_coef, C, S_w, kr, kz, dt,
    use_true_rho=False,
):
    """Advance E, B over one timestep with the standard PSATD scheme."""
    if use_true_rho:
        rho_diff = rho_next * rho_next_coef - rho_prev * rho_prev_coef
    else:
        divE = (Ep - Em) * kr + 1j * (Ez * kz)
        divJ = (Jp - Jm) * kr + 1j * (Jz * kz)
        rho_diff = (
            divE * ((rho_next_coef - rho_prev_coef) * epsilon_0)
            - divJ * (rho_next_coef * dt)
        )

    Ep_new = Ep * C + rho_diff * (0.5 * kr) + (
        (1j * (Bz * kr)) * (-0.5) + Bp * kz - Jp * mu_0
    ) * (c2 * S_w)
    Em_new = Em * C - rho_diff * (0.5 * kr) + (
        (1j * (Bz * kr)) * (-0.5) - Bm * kz - Jm * mu_0
    ) * (c2 * S_w)
    Ez_new = Ez * C - (1j * rho_diff) * kz + (
        1j * (Bp * kr) + 1j * (Bm * kr) - Jz * mu_0
    ) * (c2 * S_w)

    Bp_new = Bp * C - ((1j * (Ez * kr)) * (-0.5) + Ep * kz) * S_w + (
        (1j * (Jz * kr)) * (-0.5) + Jp * kz
    ) * j_coef
    Bm_new = Bm * C - ((1j * (Ez * kr)) * (-0.5) - Em * kz) * S_w + (
        (1j * (Jz * kr)) * (-0.5) - Jm * kz
    ) * j_coef
    Bz_new = Bz * C - (1j * (Ep * kr) + 1j * (Em * kr)) * S_w + (
        1j * (Jp * kr) + 1j * (Jm * kr)
    ) * j_coef

    return Ep_new, Em_new, Ez_new, Bp_new, Bm_new, Bz_new


def push_eb_pml_standard(Ep_pml, Em_pml, Bp_pml, Bm_pml, Ez, Bz, C, S_w,
                         kr, kz):
    """Advance the radial-PML split fields (standard scheme)."""
    half_iBz = (1j * (Bz * kr)) * (-0.5)
    half_iEz = (1j * (Ez * kr)) * (-0.5)
    return (Ep_pml * C + half_iBz * (c2 * S_w),
            Em_pml * C + half_iBz * (c2 * S_w),
            Bp_pml * C - half_iEz * S_w,
            Bm_pml * C - half_iEz * S_w)


def push_eb_comoving(
    Ep, Em, Ez, Bp, Bm, Bz, Jp, Jm, Jz, rho_prev, rho_next,
    rho_prev_coef, rho_next_coef, j_coef, C, S_w, T_eb, T_cc, T_rho,
    kr, kz, dt, V, use_true_rho=False,
):
    """Advance E, B with the Galilean / comoving-current PSATD scheme
    (V: the comoving velocity)."""
    if use_true_rho:
        rho_diff = rho_next * rho_next_coef - rho_prev * rho_prev_coef
    else:
        divE = (Ep - Em) * kr + 1j * (Ez * kz)
        divJ = (Jp - Jm) * kr + 1j * (Jz * kz)
        rho_diff = (
            divE * ((T_eb * rho_next_coef - rho_prev_coef) * epsilon_0)
            + divJ * (T_rho * rho_next_coef)
        )

    TC = T_eb * C
    TS = T_eb * S_w

    Ep_new = (
        Ep * TC + rho_diff * (0.5 * kr)
        + (1j * (Jp * (kz * V))) * j_coef
        + ((1j * (Bz * kr)) * (-0.5) + Bp * kz - Jp * T_cc * mu_0) * (TS * c2)
    )
    Em_new = (
        Em * TC - rho_diff * (0.5 * kr)
        + (1j * (Jm * (kz * V))) * j_coef
        + ((1j * (Bz * kr)) * (-0.5) - Bm * kz - Jm * T_cc * mu_0) * (TS * c2)
    )
    Ez_new = (
        Ez * TC - (1j * rho_diff) * kz
        + (1j * (Jz * (kz * V))) * j_coef
        + (1j * (Bp * kr) + 1j * (Bm * kr) - Jz * T_cc * mu_0) * (TS * c2)
    )

    Bp_new = (
        Bp * TC
        - ((1j * (Ez * kr)) * (-0.5) + Ep * kz) * TS
        + ((1j * (Jz * kr)) * (-0.5) + Jp * kz) * j_coef
    )
    Bm_new = (
        Bm * TC
        - ((1j * (Ez * kr)) * (-0.5) - Em * kz) * TS
        + ((1j * (Jz * kr)) * (-0.5) - Jm * kz) * j_coef
    )
    Bz_new = (
        Bz * TC
        - (1j * (Ep * kr) + 1j * (Em * kr)) * TS
        + (1j * (Jp * kr) + 1j * (Jm * kr)) * j_coef
    )

    return Ep_new, Em_new, Ez_new, Bp_new, Bm_new, Bz_new


def push_eb_pml_comoving(Ep_pml, Em_pml, Bp_pml, Bm_pml, Ez, Bz, C, S_w,
                         T_eb, kr, kz):
    """Advance the radial-PML split fields (Galilean / comoving scheme)."""
    TC = T_eb * C
    TS = T_eb * S_w
    half_iBz = (1j * (Bz * kr)) * (-0.5)
    half_iEz = (1j * (Ez * kr)) * (-0.5)
    return (Ep_pml * TC + half_iBz * TS * c2,
            Em_pml * TC + half_iBz * TS * c2,
            Bp_pml * TC - half_iEz * TS,
            Bm_pml * TC - half_iEz * TS)


def correct_currents_curlfree_standard(
    rho_prev, rho_next, Jp, Jm, Jz, kz, kr, inv_k2, inv_dt, drho=None
):
    """Curl-free current correction (standard scheme).

    `drho`: optional directly-deposited rho_next - rho_prev (float32
    runs; avoids the catastrophic cancellation of the background
    density in the grid difference)."""
    d = drho if drho is not None else (rho_next - rho_prev)
    F = (d * inv_dt + 1j * (Jz * kz) + (Jp - Jm) * kr) * (-inv_k2)
    return Jp + F * (0.5 * kr), Jm - F * (0.5 * kr), Jz - (1j * F) * kz


def correct_currents_curlfree_comoving(
    rho_prev, rho_next, Jp, Jm, Jz, kz, kr, inv_k2, j_corr_coef, T_eb, T_cc,
    inv_dt
):
    """Curl-free current correction (Galilean / comoving scheme)."""
    F = ((rho_next - rho_prev * T_eb) * (T_cc * j_corr_coef)
         + 1j * (Jz * kz) + (Jp - Jm) * kr) * (-inv_k2)
    return Jp + F * (0.5 * kr), Jm - F * (0.5 * kr), Jz - (1j * F) * kz


def _safe_inv(k):
    """1/k, 0 where k = 0."""
    return torch.where(k != 0, 1.0 / torch.where(k == 0, torch.ones_like(k),
                                                 k), torch.zeros_like(k))


def correct_currents_crossdeposition_standard(
    rho_prev, rho_next, rho_next_z, rho_next_xy, Jp, Jm, Jz, kz, kr, inv_dt
):
    """Cross-deposition current correction (standard scheme)."""
    Dz = 1j * (Jz * kz) + (
        rho_next - rho_next_xy + rho_next_z - rho_prev) * (0.5 * inv_dt)
    Dxy = (Jp - Jm) * kr + (
        rho_next - rho_next_z + rho_next_xy - rho_prev) * (0.5 * inv_dt)
    inv_kr = _safe_inv(kr)
    inv_kz = _safe_inv(kz)
    return (Jp - Dxy * (0.5 * inv_kr), Jm + Dxy * (0.5 * inv_kr),
            Jz + (1j * Dz) * inv_kz)


def correct_currents_crossdeposition_comoving(
    rho_prev, rho_next, rho_next_z, rho_next_xy, Jp, Jm, Jz, kz, kr,
    j_corr_coef, T_eb, T_cc, inv_dt
):
    """Cross-deposition current correction (Galilean / comoving scheme)."""
    half_coef = T_cc * j_corr_coef * 0.5
    Dz = 1j * (Jz * kz) + (
        rho_next - rho_next_xy * T_eb + rho_next_z - rho_prev * T_eb
    ) * half_coef
    Dxy = (Jp - Jm) * kr + (
        rho_next + rho_next_xy * T_eb - rho_next_z - rho_prev * T_eb
    ) * half_coef
    inv_kr = _safe_inv(kr)
    inv_kz = _safe_inv(kz)
    return (Jp - Dxy * (0.5 * inv_kr), Jm + Dxy * (0.5 * inv_kr),
            Jz + (1j * Dz) * inv_kz)


def correct_divE(rho_prev, Ep, Em, Ez, kz, kr, inv_k2):
    """Correct E so that div(E) = rho/epsilon_0."""
    F = (rho_prev * (-1.0 / epsilon_0) + 1j * (Ez * kz)
         + (Ep - Em) * kr) * (-inv_k2)
    return Ep + F * (0.5 * kr), Em - F * (0.5 * kr), Ez - (1j * F) * kz


def filter_scalar(field, filter_z, filter_r):
    """Multiply a spectral scalar by the separable k-space filter.

    filter_z: (Nz,) real; filter_r: (Nm, Nr) real.
    """
    return field * (filter_z[None, :, None] * filter_r[:, None, :])


def filter_vector(Fp, Fm, Fz, filter_z, filter_r):
    f = filter_z[None, :, None] * filter_r[:, None, :]
    return Fp * f, Fm * f, Fz * f

"""PSATD field advance, curl-free current correction and source filters.

Field arrays are complex tensors stacked over azimuthal modes,
(Nm, Nz, Nr); coefficient arrays are real.  Each function is the
elementwise k-space update of the standard (non-Galilean) spectral
solver.  Behavioral reference: FBPIC's fbpic/fields/
numba_methods.py:64-382.
"""
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


def filter_scalar(field, filter_z, filter_r):
    """Multiply a spectral scalar by the separable k-space filter.

    filter_z: (Nz,) real; filter_r: (Nm, Nr) real.
    """
    return field * (filter_z[None, :, None] * filter_r[:, None, :])


def filter_vector(Fp, Fm, Fz, filter_z, filter_r):
    f = filter_z[None, :, None] * filter_r[:, None, :]
    return Fp * f, Fm * f, Fz * f

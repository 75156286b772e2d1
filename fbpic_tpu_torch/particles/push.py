"""Relativistic particle pushers (elementwise over particle tensors).

Vay pusher: Vay, Physics of Plasmas 15, 056701 (2008).
Behavioral reference: FBPIC's fbpic/particles/push/inline_functions.py
and push/numba_methods.py.
"""
import torch

from ..constants import c


def push_p_vay(ux, uy, uz, inv_gamma, Ex, Ey, Ez, Bx, By, Bz, econst, bconst):
    """One Vay momentum step.  econst = q dt/(m c); bconst = q dt/(2 m)."""
    taux = bconst * Bx
    tauy = bconst * By
    tauz = bconst * Bz
    tau2 = taux**2 + tauy**2 + tauz**2

    uxp = ux + econst * Ex + inv_gamma * (uy * tauz - uz * tauy)
    uyp = uy + econst * Ey + inv_gamma * (uz * taux - ux * tauz)
    uzp = uz + econst * Ez + inv_gamma * (ux * tauy - uy * taux)
    sigma = 1 + uxp**2 + uyp**2 + uzp**2 - tau2
    utau = uxp * taux + uyp * tauy + uzp * tauz

    inv_gamma_f = torch.sqrt(
        2.0 / (sigma + torch.sqrt(sigma**2 + 4 * (tau2 + utau**2))))

    tx = inv_gamma_f * taux
    ty = inv_gamma_f * tauy
    tz = inv_gamma_f * tauz
    ut = inv_gamma_f * utau
    s = 1.0 / (1 + tau2 * inv_gamma_f**2)

    ux_f = s * (uxp + tx * ut + uyp * tz - uzp * ty)
    uy_f = s * (uyp + ty * ut + uzp * tx - uxp * tz)
    uz_f = s * (uzp + tz * ut + uxp * ty - uyp * tx)
    return ux_f, uy_f, uz_f, inv_gamma_f


def push_p(ptcl, E, B, q, m, dt, z_plane=None):
    """Momentum push for a whole species; returns (ux, uy, uz, inv_gamma).

    E, B: tuples (Ex, Ey, Ez) / (Bx, By, Bz) of per-particle fields.
    z_plane: optional host number or 0-d tensor of the working dtype
    (the chunk runner's, core/graph.py) -- particles with z <= z_plane
    keep their momenta (ballistic-before-plane injection); the
    comparison runs in the working dtype either way.  An ionizable
    species' charge is ionization_level * q."""
    econst = q * dt / (m * c)
    bconst = 0.5 * q * dt / m
    level = getattr(ptcl, "ionization_level", None)
    if level is not None:
        lev = level.to(ptcl.ux.dtype)
        econst = econst * lev
        bconst = bconst * lev
    ux, uy, uz, inv_gamma = push_p_vay(ptcl.ux, ptcl.uy, ptcl.uz,
                                       ptcl.inv_gamma, *E, *B, econst,
                                       bconst)
    if z_plane is not None:
        keep = ptcl.z > (z_plane if torch.is_tensor(z_plane)
                         else float(z_plane))
        ux = torch.where(keep, ux, ptcl.ux)
        uy = torch.where(keep, uy, ptcl.uy)
        uz = torch.where(keep, uz, ptcl.uz)
        inv_gamma = torch.where(keep, inv_gamma, ptcl.inv_gamma)
    return ux, uy, uz, inv_gamma


def push_x(ptcl, dt, x_push=1.0, y_push=1.0, z_push=1.0):
    """Position push over dt with per-axis +/- coefficients.
    Returns new (x, y, z)."""
    chdt = c * dt
    x = ptcl.x + chdt * ptcl.inv_gamma * x_push * ptcl.ux
    y = ptcl.y + chdt * ptcl.inv_gamma * y_push * ptcl.uy
    z = ptcl.z + chdt * ptcl.inv_gamma * z_push * ptcl.uz
    return x, y, z


def _kahan_add(x, comp, dx):
    """One compensated accumulation step: returns (x_new, comp_new)
    such that x_new + comp_new ~= x + comp + dx to ~2x working
    precision (Kahan-Neumaier)."""
    y = dx + comp
    t = x + y
    comp = y - (t - x)
    return t, comp


def push_x_compensated(ptcl, dt, x_push=1.0, y_push=1.0, z_push=1.0):
    """Position push with Kahan-compensated accumulation.
    Returns (x, y, z, comp_x, comp_y, comp_z)."""
    chdt = c * dt
    dx = chdt * ptcl.inv_gamma * x_push * ptcl.ux
    dy = chdt * ptcl.inv_gamma * y_push * ptcl.uy
    dz = chdt * ptcl.inv_gamma * z_push * ptcl.uz
    x, cx = _kahan_add(ptcl.x, ptcl.comp_x, dx)
    y, cy = _kahan_add(ptcl.y, ptcl.comp_y, dy)
    z, cz = _kahan_add(ptcl.z, ptcl.comp_z, dz)
    return x, y, z, cx, cy, cz

"""Compton scattering against a rigid counter-propagating Gaussian laser.

Monte-Carlo Klein-Nishina scattering evaluated in the electron rest
frame (boosted-frame compatible); the laser is not on the grid but a
rigid photon flux.  Port of fbpic_tpu's particles/compton.py; reference
physics: FBPIC's fbpic/particles/elementary_process/compton/
(compton.py:24-160, numba_methods.py:54-264, inline_functions.py):

- each electron emits ``nscatter = int(p * ratio + U)`` photon
  macroparticles a step (numba_methods.py:93-99);
- the rest-frame scattering angle is drawn from the Klein-Nishina
  angular distribution with Ozmutl's rejection method
  (numba_methods.py:180-202), vectorized as a bank of N_REJECT candidate
  draws per photon, the first accepted one winning (the envelope
  accepts >= 50%, so 16 candidates leave < 2e-5 without one);
- the scattered momentum is taken relative to the actual direction of
  the incoming photon in the rest frame (numba_methods.py:157-243);
- electrons recoil with probability 1/ratio_w_electron_photon by the
  momentum of one photon (numba_methods.py:250-264).

As in fbpic_tpu, the photons fill a fixed-size buffer by a searchsorted
repeat (electron i fills slots [cum_i - n_i, cum_i)), and carry the
normalized momentum u = p/(m_e c) with inv_gamma = 1/|u|: the push moves
them at c.  Every random number comes from the caller (``handle_compton``'s
``draw``), one named draw per fbpic_tpu ``jax.random`` call.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import c, m_e, hbar

R_E = 2.8179403262e-15
PI_RE_2 = np.pi * R_E**2
INV_MC = 1.0 / (m_e * c)
# Candidate draws per photon of the rejection sampling
N_REJECT = 16


@dataclass(frozen=True)
class ComptonConfig:
    """Static Compton-scattering settings of one (electron) species."""
    target_index: int            # species receiving the photons
    ratio_w_electron_photon: float = 1.0
    buffer_size: int = 8192


@dataclass
class ComptonAux:
    """The laser flux's parameters: 0-d tensors of the working dtype on
    the simulation's device (so they round as fbpic_tpu's device
    scalars do)."""
    photon_n_lab_peak: torch.Tensor   # peak photon density [1/m^3]
    photon_p: torch.Tensor            # photon momentum (simulation frame)
    photon_beta_z: torch.Tensor       # -1: counter-propagating
    inv_waist2: torch.Tensor
    inv_ctau2: torch.Tensor
    z0: torch.Tensor
    gamma_boost: torch.Tensor
    beta_boost: torch.Tensor


def build_compton_aux(laser_energy, laser_wavelength, laser_waist,
                      laser_ctau, laser_initial_z0, boost=None, *, device,
                      dtype=torch.float64):
    """Host-side setup (reference: compton.py:55-140)."""
    photon_lab_p = 2 * np.pi * hbar / laser_wavelength
    effective_volume = (np.pi / 2.0) ** 1.5 * laser_waist**2 * laser_ctau
    photon_n_lab_peak = laser_energy / (effective_volume * photon_lab_p * c)
    gamma_boost = 1.0 if boost is None else boost.gamma0
    beta_boost = 0.0 if boost is None else boost.beta0
    # The counter-propagating (-z) photon momentum in the simulation frame
    photon_p_sim = gamma_boost * (1 + beta_boost) * photon_lab_p

    def dev(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return ComptonAux(
        photon_n_lab_peak=dev(photon_n_lab_peak), photon_p=dev(photon_p_sim),
        photon_beta_z=dev(-1.0), inv_waist2=dev(1.0 / laser_waist**2),
        inv_ctau2=dev(1.0 / laser_ctau**2), z0=dev(laser_initial_z0),
        gamma_boost=dev(gamma_boost), beta_boost=dev(beta_boost))


def _lorentz_transform(p, px, py, pz, gamma, beta, nx, ny, nz):
    """4-momentum boost along the unit direction (nx, ny, nz)
    (reference: inline_functions.py:17-41)."""
    p_par = nx * px + ny * py + nz * pz
    p_out = gamma * (p - beta * p_par)
    p_par_out = gamma * (p_par - beta * p)
    d = p_par_out - p_par
    return p_out, px + nx * d, py + ny * d, pz + nz * d


def scattering_probability(sp, aux: ComptonAux, dt, time):
    """Each electron's probability of scattering during dt (reference:
    inline_functions.py:44-86).  time: a host number, or a 0-d tensor
    of the working dtype (the step's, which the chunk runner takes from
    its tables, core/graph.py): c * time then rounds as fbpic_tpu's
    traced scalar does."""
    ct = c * time
    # Photon density at each electron (lab-frame Gaussian, rigid motion)
    zlab = aux.gamma_boost * (sp.z + aux.beta_boost * ct)
    ctlab = aux.gamma_boost * (ct + aux.beta_boost * sp.z)
    n_lab = aux.photon_n_lab_peak * torch.exp(
        -2 * aux.inv_waist2 * (sp.x**2 + sp.y**2)
        - 2 * aux.inv_ctau2 * (zlab - aux.z0 + ctlab) ** 2)
    photon_n = aux.gamma_boost * n_lab * (1 + aux.beta_boost)

    gamma = 1.0 / sp.inv_gamma
    transform = gamma - sp.uz * aux.photon_beta_z
    n_rest = photon_n * transform
    p_rest_mag = aux.photon_p * transform

    k = torch.clamp(p_rest_mag * INV_MC, min=1e-30)
    f1 = 2 * (2 + k * (1 + k) * (8 + k)) / (k**2 * (1 + 2 * k) ** 2)
    f2 = (2 + k * (2 - k)) * torch.log1p(2 * k) / k**3
    sigma = PI_RE_2 * (f1 - f2)
    proper_dt = dt * sp.inv_gamma
    return 1.0 - torch.exp(-sigma * n_rest * c * proper_dt)


def _sample_kn_angle(k, r1, r2):
    """cos(theta) drawn from the Klein-Nishina angular distribution by
    Ozmutl's rejection method (reference: numba_methods.py:180-202):
    N_REJECT candidates per sample (the uniform banks r1, r2 of shape
    (B, N_REJECT)), the first accepted one winning.  k: (B,) the
    rest-frame incoming photon momentum / (m_e c)."""
    c0 = 2.0 * (2.0 * k**2 + 2.0 * k + 1.0) / (2.0 * k + 1.0) ** 3
    b = (2.0 + c0) / (2.0 - c0)
    a = 2.0 * b - 1.0
    x = b[:, None] - (b[:, None] + 1.0) * (0.5 * c0[:, None]) ** r1
    h = a[:, None] / (b[:, None] - x)
    factor = 1.0 + k[:, None] * (1.0 - x)
    f = ((1.0 + x**2) * factor + k[:, None] ** 2 * (1.0 - x) ** 2) / factor**3
    accept = r2 < f / h
    # The first accepted candidate (argmax returns the first maximum);
    # the last one where none is (probability < 2e-5)
    first = torch.argmax(accept.to(torch.int32), dim=1)
    pick = torch.where(accept.any(dim=1), first,
                       torch.full_like(first, N_REJECT - 1))
    return torch.gather(x, 1, pick[:, None])[:, 0]


def handle_compton(sp, cfg: ComptonConfig, aux: ComptonAux, dt, time, draw):
    """One Compton step of one species: decide the scatterings, emit the
    photons, apply the recoil.

    time: the time of the scattering (t + dt/2), a host number or a 0-d
    tensor of the working dtype (scattering_probability); draw(name, shape):
    the uniform draws in [0, 1) (``compton_phi`` in [0, 2 pi)), one per
    fbpic_tpu ``jax.random`` call: ``compton_u`` (N,), ``compton_r1`` and
    ``compton_r2`` (B, N_REJECT), ``compton_phi`` (B,), ``compton_recoil``
    (N,), with N the slots and B the buffer size.

    Returns (ux, uy, uz, inv_gamma of the species after the recoil, the
    photon buffer: a dict of (B,) tensors, w = 0 past the photons)."""
    ratio = cfg.ratio_w_electron_photon
    inv_ratio = 1.0 / ratio
    B = cfg.buffer_size
    N = sp.w.shape[0]
    dev = sp.w.device

    # --- How many photon macroparticles each electron emits
    p_scatter = scattering_probability(sp, aux, dt, time)
    u_draw = draw("compton_u", (N,))
    nscatter = torch.floor(p_scatter * ratio + u_draw).to(torch.int64)
    nscatter = torch.where(sp.w != 0, nscatter, torch.zeros_like(nscatter))

    # --- The incoming photon in each electron's rest frame
    gamma_e = 1.0 / sp.inv_gamma
    u_norm = torch.sqrt(sp.ux**2 + sp.uy**2 + sp.uz**2)
    has_u = u_norm > 0
    zero, one = torch.zeros_like(u_norm), torch.ones_like(u_norm)
    inv_u = torch.where(has_u, 1.0 / torch.where(has_u, u_norm, one), zero)
    nx = torch.where(has_u, sp.ux * inv_u, zero)
    ny = torch.where(has_u, sp.uy * inv_u, zero)
    nz = torch.where(has_u, sp.uz * inv_u, one)
    beta_e = u_norm * sp.inv_gamma
    pin = aux.photon_p
    pin_z = aux.photon_p * aux.photon_beta_z
    rp, rpx, rpy, rpz = _lorentz_transform(
        pin, zero, zero, pin_z.expand(nx.shape), gamma_e, beta_e, nx, ny, nz)
    # Spherical angles of the incoming photon direction (rest frame)
    cos_t = torch.clamp(rpz / rp, -1.0, 1.0)
    sin_t2 = torch.clamp(1.0 - cos_t**2, min=0.0)
    on_axis = sin_t2 <= 0.0
    sin_t = torch.sqrt(sin_t2)
    inv_pxy = torch.where(on_axis, zero,
                          1.0 / torch.where(on_axis, one, sin_t * rp))
    cos_p = torch.where(on_axis, one, rpx * inv_pxy)
    sin_p = torch.where(on_axis, zero, rpy * inv_pxy)

    # --- The photon buffer: electron i owns slots
    #     [cum_i - nscatter_i, cum_i)
    cum = torch.cumsum(nscatter, 0)
    slot = torch.arange(B, device=dev)
    if N:
        total = cum[-1]
        src = torch.searchsorted(cum, slot, right=True)
    else:
        total = torch.zeros((), dtype=torch.int64, device=dev)
        src = torch.zeros_like(slot)
    valid = slot < torch.clamp(total, max=B)
    src = torch.where(valid, src, torch.zeros_like(src))

    def g(arr):
        return arr[src]

    k_ph = torch.clamp(g(rp) * INV_MC, min=1e-30)
    x = _sample_kn_angle(k_ph, draw("compton_r1", (B, N_REJECT)),
                         draw("compton_r2", (B, N_REJECT)))   # cos(theta_s)
    phi_s = draw("compton_phi", (B,))
    p_out = g(rp) / (1.0 + k_ph * (1.0 - x))
    sin_ts = torch.sqrt(torch.clamp(1.0 - x**2, min=0.0))
    pX = p_out * sin_ts * torch.cos(phi_s)
    pY = p_out * sin_ts * torch.sin(phi_s)
    pZ = p_out * x
    # From the incoming photon's axes to the rest-frame axes
    # (reference: numba_methods.py:216-227)
    ct_, st_ = g(cos_t), g(sin_t)
    cp_, sp_ = g(cos_p), g(sin_p)
    npx = st_ * cp_ * pZ + ct_ * cp_ * pX - sp_ * pY
    npy = st_ * sp_ * pZ + ct_ * sp_ * pX + cp_ * pY
    npz = ct_ * pZ - st_ * pX
    # Back to the simulation frame (a boost by -beta)
    p_sim, px_sim, py_sim, pz_sim = _lorentz_transform(
        p_out, npx, npy, npz, g(gamma_e), g(beta_e), -g(nx), -g(ny), -g(nz))

    up = torch.clamp(p_sim * INV_MC, min=1e-30)
    vmask = valid.to(sp.w.dtype)
    photons = dict(
        x=g(sp.x) * vmask, y=g(sp.y) * vmask, z=g(sp.z) * vmask,
        ux=px_sim * INV_MC * vmask, uy=py_sim * INV_MC * vmask,
        uz=pz_sim * INV_MC * vmask,
        inv_gamma=torch.where(valid, 1.0 / up, torch.ones_like(up)),
        w=g(sp.w) * inv_ratio * vmask)

    # --- Electron recoil: with probability 1/ratio, by the momentum of
    # one full photon, the last one it emitted
    # (reference: numba_methods.py:250-264)
    last_slot = torch.clamp(cum - 1, 0, B - 1)
    got_photon = (nscatter > 0) & (cum - 1 < B)
    r_rec = draw("compton_recoil", (N,))
    do_recoil = got_photon & (r_rec < inv_ratio)
    dux = INV_MC * (0.0 - px_sim[last_slot])
    duy = INV_MC * (0.0 - py_sim[last_slot])
    duz = INV_MC * (pin_z - pz_sim[last_slot])
    ux_e = torch.where(do_recoil, sp.ux + dux, sp.ux)
    uy_e = torch.where(do_recoil, sp.uy + duy, sp.uy)
    uz_e = torch.where(do_recoil, sp.uz + duz, sp.uz)
    ig_e = 1.0 / torch.sqrt(1 + ux_e**2 + uy_e**2 + uz_e**2)
    return (ux_e, uy_e, uz_e, ig_e), photons

"""Continuous plasma injection for the moving window.

Each injecting species keeps a per-column particle template
(``InjectorAux``, built on the host with the simulation's numpy RNG,
exactly like fbpic_tpu).  Every exchange, the columns the window
uncovered are generated from the template; each column is rotated by an
angle from a replaceable source so the finite-p_nt sampling noise is not
coherent along z (the reference redraws random angles for each injected
batch, continuous_injection.py:230).  fbpic_tpu draws those angles from
``jax.random``; the port's default source is a ``torch.Generator``
(``GeneratorAngles``), and a caller can substitute any callable, e.g.
one that reproduces fbpic_tpu's draws.
"""
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class InjectorConfig:
    """Static continuous-injection parameters of one species."""
    dz_particles: float
    n: float
    ux_m: float = 0.0
    uy_m: float = 0.0
    uz_m: float = 0.0
    ux_th: float = 0.0
    uy_th: float = 0.0
    uz_th: float = 0.0
    dens_func: object = None     # numpy callable (z, r) or (x, y, z)
    dens_args: str = "zr"        # 'zr' or 'xyz'
    # Max columns injected in one exchange (>= exchange_period * p_nz
    # * cells moved per step, plus margin)
    max_inject_cols: int = 4

    @property
    def v_end_plasma(self):
        from ..constants import c
        gamma = np.sqrt(1 + self.ux_m**2 + self.uy_m**2 + self.uz_m**2)
        return c * self.uz_m / gamma


@dataclass
class InjectorAux:
    """Template of one injected column of particles, (col_size,) each."""
    r: torch.Tensor
    cos_t: torch.Tensor
    sin_t: torch.Tensor
    w_base: torch.Tensor


def build_injector_aux(Npr, rmin, rmax, Nptheta, injector: InjectorConfig,
                       rng=None, device="cpu",
                       dtype=torch.float64) -> InjectorAux:
    """Host-side construction of the per-column particle template."""
    rng = rng or np.random
    dr_p = (rmax - rmin) / max(Npr, 1)
    r_reg = rmin + dr_p * (np.arange(Npr) + 0.5)
    dtheta = 2 * np.pi / Nptheta
    theta_reg = dtheta * np.arange(Nptheta)
    rp, thetap = np.meshgrid(r_reg, theta_reg, indexing="ij")
    # Unalign the angles between radial rows (same shift per row)
    thetap = thetap + 2 * np.pi * rng.random_sample((Npr, 1))
    r = rp.flatten()
    theta = thetap.flatten()
    w = injector.n * r * dtheta * dr_p * injector.dz_particles

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return InjectorAux(r=dev(r), cos_t=dev(np.cos(theta)),
                       sin_t=dev(np.sin(theta)), w_base=dev(w))


class GeneratorAngles:
    """Default column-angle source: uniform angles in [0, 2 pi) drawn
    from a ``torch.Generator``.

    Called as ``source(iteration, species_index, nkey)`` with ``nkey``
    the (max_cols,) integer index of each candidate column (its position
    in units of the column spacing); returns the (max_cols,) angles."""

    def __init__(self, generator):
        self.generator = generator

    def __call__(self, iteration, species_index, nkey):
        u = torch.rand(nkey.shape, generator=self.generator,
                       dtype=torch.float64, device=self.generator.device)
        return (2.0 * np.pi * u).to(nkey.device)


def generate_columns(inj_cfg: InjectorConfig, inj_aux: InjectorAux,
                     z_end, n_cols, phi_of, generator):
    """Generate max_inject_cols candidate columns starting at z_end.

    ``z_end``: numpy scalar of the working dtype; ``n_cols``: int.
    ``phi_of(nkey)``: the column angles.  Columns with index >= n_cols
    get zero weight.  Returns a dict of (max_inject_cols * col_size,)
    tensors and the new z_end.
    """
    dtype, device = inj_aux.r.dtype, inj_aux.r.device
    col_size = inj_aux.r.shape[0]
    dz_p = inj_cfg.dz_particles
    max_cols = inj_cfg.max_inject_cols

    cols_idx = torch.arange(max_cols, device=device)
    active = (cols_idx < n_cols).to(dtype)
    z_cols = torch.tensor(z_end, dtype=dtype, device=device) \
        + (cols_idx.to(dtype) + 0.5) * dz_p
    r = inj_aux.r.repeat(max_cols)
    w = inj_aux.w_base.repeat(max_cols) * active.repeat_interleave(col_size)
    z = z_cols.repeat_interleave(col_size)

    nkey = torch.floor(z_cols / dz_p + 0.5).to(torch.int32)
    phi = phi_of(nkey).to(device=device, dtype=dtype)
    cphi = torch.cos(phi).repeat_interleave(col_size)
    sphi = torch.sin(phi).repeat_interleave(col_size)
    cos_t = inj_aux.cos_t.repeat(max_cols)
    sin_t = inj_aux.sin_t.repeat(max_cols)
    cos_r = cos_t * cphi - sin_t * sphi
    sin_r = sin_t * cphi + cos_t * sphi
    x = r * cos_r
    y = r * sin_r

    if inj_cfg.dens_func is not None:
        # User density functions are numpy code: evaluate on the host
        if inj_cfg.dens_args == "xyz":
            args = dict(x=x, y=y, z=z)
        else:
            args = dict(z=z, r=r)
        dens = inj_cfg.dens_func(**{k: v.cpu().numpy()
                                    for k, v in args.items()})
        w = torch.clamp(w * torch.as_tensor(np.asarray(dens), dtype=dtype,
                                            device=device), min=0.0)

    ntot = max_cols * col_size

    def momentum(mean, spread):
        u = torch.full((ntot,), mean, dtype=dtype, device=device)
        if spread != 0.0:
            u = u + spread * torch.randn(
                ntot, generator=generator, dtype=dtype,
                device=generator.device).to(device)
        return u

    ux = momentum(inj_cfg.ux_m, inj_cfg.ux_th)
    uy = momentum(inj_cfg.uy_m, inj_cfg.uy_th)
    uz = momentum(inj_cfg.uz_m, inj_cfg.uz_th)
    inv_gamma = 1.0 / torch.sqrt(1 + ux**2 + uy**2 + uz**2)
    np_dtype = type(z_end)
    new_z_end = z_end + np_dtype(n_cols) * dz_p
    return dict(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz,
                inv_gamma=inv_gamma, w=w), new_z_end

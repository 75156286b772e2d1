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

A user's density function is probed once, when its species is added
(``probe_dens_func``, the counterpart of fbpic_tpu's
``ensure_traceable_dens``): one that torch evaluates on tensors
without reading their values is called on the device at every
injection (inside the chunk runner's CUDA graphs, as fbpic_tpu traces a
``jnp`` function into its program); any other function gets numpy
arrays on the host, as fbpic_tpu's ``pure_callback`` evaluates it.
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
    dens_func: object = None     # callable (z, r) or (x, y, z)
    dens_args: str = "zr"        # 'zr' or 'xyz'
    # dens_func evaluated on the device, with tensors (probe_dens_func);
    # else on the host, with numpy arrays
    dens_on_device: bool = False
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
                       rng=None, *, device,
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


def probe_dens_func(dens_func, dens_args, *, dtype):
    """Whether ``dens_func`` runs on the device: called once on small
    tensors of torch's meta device (a shape and a dtype, no values), it
    returns a tensor of their shape there.  A function that reads the
    values -- numpy code (a ufunc turns a CPU tensor into an array, but
    not one without values), a host read (``float``, ``.item()``) --
    raises there, whatever the run's device: the CPU decides as the card
    does.  A function that raises or returns anything else is evaluated
    on the host."""
    keys = ("x", "y", "z") if dens_args == "xyz" else ("z", "r")
    probe = torch.empty(4, dtype=dtype, device="meta")
    try:
        out = dens_func(**{k: probe for k in keys})
    except Exception:
        return False
    return torch.is_tensor(out) and out.shape == probe.shape \
        and out.device == probe.device


def generate_columns(inj_cfg: InjectorConfig, inj_aux: InjectorAux,
                     z_end, n_cols, phi_of, generator):
    """Generate max_inject_cols candidate columns starting at z_end.

    ``z_end`` and ``n_cols``: host values (a numpy scalar of the working
    dtype, an int) or 0-d tensors of the step's scalars (the working
    dtype, int64): the same values either way.  ``phi_of(nkey)``: the
    column angles.  Columns with index >= n_cols get zero weight.
    Returns a dict of (max_inject_cols * col_size,) tensors.
    """
    dtype, device = inj_aux.r.dtype, inj_aux.r.device
    col_size = inj_aux.r.shape[0]
    dz_p = inj_cfg.dz_particles
    max_cols = inj_cfg.max_inject_cols

    cols_idx = torch.arange(max_cols, device=device)
    active = (cols_idx < n_cols).to(dtype)
    # A host z_end joins as a scalar operand: a tensor made from it
    # would be a blocking host copy
    z_cols = (cols_idx.to(dtype) + 0.5) * dz_p + (
        z_end if torch.is_tensor(z_end) else float(z_end))
    r = inj_aux.r.repeat(max_cols)
    w = inj_aux.w_base.repeat(max_cols) * active.repeat_interleave(col_size)
    z = z_cols.repeat_interleave(col_size)

    # Times the reciprocal, not over dz_p: XLA rewrites a division by a
    # constant so, and z_cols / dz_p lies on the rounding knife edge
    # (a half-integer) that picks the key
    inv_dz_p = float(np.dtype(str(dtype).split(".")[-1]).type(1.0)
                     / np.dtype(str(dtype).split(".")[-1]).type(dz_p))
    nkey = torch.floor(z_cols * inv_dz_p + 0.5).to(torch.int32)
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
        if inj_cfg.dens_args == "xyz":
            args = dict(x=x, y=y, z=z)
        else:
            args = dict(z=z, r=r)
        if inj_cfg.dens_on_device:
            dens = inj_cfg.dens_func(**args).to(dtype)
        else:
            # numpy code: evaluated on the host
            dens = torch.as_tensor(np.asarray(inj_cfg.dens_func(
                **{k: v.cpu().numpy() for k, v in args.items()})),
                dtype=dtype, device=device)
        w = torch.clamp(w * dens, min=0.0)

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
    return dict(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz,
                inv_gamma=inv_gamma, w=w)


def write_ring(arr, start, new_vals, capacity, mask=None):
    """Write ``new_vals`` into a copy of ``arr`` from slot ``start`` on,
    wrapping mod ``capacity`` (the ring cursor of a non-resident
    species).  Slots where ``mask`` is False keep their old content.

    A write longer than the ring lands in runs of ``capacity`` slots,
    one after the other, so where slots repeat the later values win;
    the kept old values are those before the write."""
    n = new_vals.shape[0]
    idx = torch.remainder(start + torch.arange(n, device=arr.device),
                          capacity)
    if mask is not None:
        new_vals = torch.where(mask, new_vals, arr[idx])
    out = arr.clone()
    for lo in range(0, n, capacity):
        out[idx[lo:lo + capacity]] = new_vals[lo:lo + capacity]
    return out

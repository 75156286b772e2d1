"""Particle state: fixed-capacity SoA tensors with validity-by-weight.

Particle arrays are allocated with a fixed capacity and unused slots
carry ``w = 0`` (they deposit nothing and their push is harmless).
Injection / removal write into free slots instead of reallocating.
The host-side loaders (`generate_evenly_spaced`, `unalign_angles`) are
plain numpy with the same ``random_seed`` behaviour as fbpic_tpu, so
both packages load bit-identical initial plasma.
"""
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class SpeciesConfig:
    """Static per-species data."""
    q: float                  # charge [C]
    m: float                  # mass [kg]
    particle_shape: str = "linear"
    # A tracer is pushed but deposits nothing
    is_tracer: bool = False
    name: str = "species"
    # Ballistic-before-plane injection (None = normal push): particles
    # behind the plane z = ballistic_z0 + ballistic_v * t keep their
    # momenta
    ballistic_z0: object = None
    ballistic_v: float = 0.0
    # Per-column slot capacity K of the sorted (Nz, K) layout
    # (0 = the species is not resident).  See sorted_deposit.py.
    sort_K: int = 0
    # Resident column-padded layout: capacity == Nz * sort_K and the
    # storage order IS the (Nz, K) column sort (see core/step.py).
    resident: bool = False
    # Re-sort strategy of resident species: "full" rebuilds the flat
    # column sort every step; "banded" re-sorts the stored rows over the
    # 2*band+1 neighbour rows, with a full sort on the steps whose
    # exchange block rewrote the storage order.
    resort: str = "full"


@dataclass
class ParticleState:
    """SoA particle tensors of one species, shape (capacity,)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    inv_gamma: torch.Tensor
    w: torch.Tensor               # macroparticle weight; 0 marks a dead slot
    # Continuous-injection bookkeeping: ring cursor (host int) and the
    # end of the loaded plasma (numpy scalar of the working dtype, so
    # the host arithmetic rounds exactly like the device dtype)
    next_free: int = 0
    inj_z_end: Optional[np.floating] = None
    # Kahan compensation words of the positions (float32 runs only):
    # per-step wake displacements are far below the float32 ULP of the
    # absolute positions and would be rounded away systematically.
    comp_x: Optional[torch.Tensor] = None
    comp_y: Optional[torch.Tensor] = None
    comp_z: Optional[torch.Tensor] = None
    # Tracking ids (particles/tracking.py): one int64 per slot, 0 in a
    # dead or never-written slot, and the next id to hand out (host int,
    # like next_free).  fbpic_tpu keeps two uint32 words per id because
    # the TPU has no 64-bit integers.
    ids: Optional[torch.Tensor] = None
    next_id: int = 0

    @property
    def capacity(self):
        return self.x.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


#: Per-particle tensor fields of ParticleState, in payload order.
ARRAY_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "inv_gamma", "w",
                "comp_x", "comp_y", "comp_z", "ids")


def pad_particle_state(sp: ParticleState, new_cap: int,
                       row_shape=None) -> ParticleState:
    """Grow every per-particle tensor to ``new_cap`` slots; the new
    slots are dead (w = 0, inv_gamma = 1, id 0).

    They are appended at the array end (a ring species: its cursor
    ``next_free`` keeps its value), or, with ``row_shape=(Nz, K_old)``,
    at the tail of each of the Nz rows of a resident species, whose
    storage order is the (Nz, K_old) column layout."""
    old = sp.capacity
    if new_cap < old:
        raise ValueError(f"cannot shrink capacity {old} -> {new_cap}")
    if new_cap == old:
        return sp
    shape = (1, old)
    if row_shape is not None:
        Nz_rows, K_old = row_shape
        if Nz_rows * K_old != old or new_cap % Nz_rows:
            raise ValueError(f"cannot grow {old} slots in {Nz_rows} rows "
                             f"of {K_old} to {new_cap}")
        shape = (Nz_rows, K_old)
    updates = {}
    for name in ARRAY_FIELDS:
        arr = getattr(sp, name)
        if arr is None:
            continue
        fill = 1.0 if name == "inv_gamma" else 0.0
        pad = torch.full((shape[0], new_cap // shape[0] - shape[1]), fill,
                         dtype=arr.dtype, device=arr.device)
        updates[name] = torch.cat([arr.reshape(shape), pad],
                                  dim=1).reshape(-1)
    return sp.replace(**updates)


def _round_capacity(n, multiple=256):
    return max(multiple, int(-(-n // multiple) * multiple))


def make_particle_state(x, y, z, ux, uy, uz, inv_gamma, w, capacity=None,
                        *, device, dtype=torch.float64) -> ParticleState:
    """Pack numpy arrays into a padded, fixed-capacity ParticleState."""
    n = len(x)
    cap = capacity if capacity is not None else _round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < number of particles {n}")

    def pad(a, fill=0.0):
        out = np.full(cap, fill, dtype=np.float64)
        out[:n] = a
        return torch.as_tensor(out, dtype=dtype, device=device)

    extra = {}
    if dtype == torch.float32:
        extra = {name: torch.zeros(cap, dtype=dtype, device=device)
                 for name in ("comp_x", "comp_y", "comp_z")}
    return ParticleState(
        x=pad(x), y=pad(y), z=pad(z),
        ux=pad(ux), uy=pad(uy), uz=pad(uz),
        inv_gamma=pad(inv_gamma, fill=1.0),
        w=pad(w, fill=0.0),
        next_free=n, **extra)


def unalign_angles(thetap, Npz, Npr, method="random", rng=None):
    """Shift angles so particles are not aligned along radial 'star arms'.

    Same shift for all Nptheta particles at one (z, r) position, which
    preserves initially-zero azimuthal modes.  Reference:
    FBPIC's fbpic/particles/injection/continuous_injection.py:275.
    """
    if method == "random":
        rng = rng or np.random
        angle_shift = 2 * np.pi * rng.random_sample((Npz, Npr))
    elif method == "irrational":
        # Golden-ratio increments: deterministic, low-discrepancy
        i = np.arange(Npz * Npr).reshape(Npz, Npr)
        angle_shift = 2 * np.pi * ((1 + np.sqrt(5)) / 2 * i % 1)
    else:
        raise ValueError(method)
    thetap += angle_shift[:, :, np.newaxis]


def _check_dens_func_arguments(dens_func):
    import inspect
    params = list(inspect.signature(dens_func).parameters.keys())
    if params[:3] == ["x", "y", "z"]:
        return ["x", "y", "z"]
    return ["z", "r"]


def generate_evenly_spaced(
    Npz, zmin, zmax, Npr, rmin, rmax, Nptheta, n, dens_func,
    ux_m=0.0, uy_m=0.0, uz_m=0.0, ux_th=0.0, uy_th=0.0, uz_th=0.0,
    rng=None,
):
    """Evenly-spaced particle loading on a z*r*theta lattice (host, numpy).

    Weights are density * cell volume (r dtheta dr dz), modulated by
    dens_func.  Reference: continuous_injection.py:203-270.
    """
    rng = rng or np.random
    if Npz * Npr * Nptheta > 0:
        dz = (zmax - zmin) * 1.0 / Npz
        z_reg = zmin + dz * (np.arange(Npz) + 0.5)
        dr = (rmax - rmin) * 1.0 / Npr
        r_reg = rmin + dr * (np.arange(Npr) + 0.5)
        dtheta = 2 * np.pi / Nptheta
        theta_reg = dtheta * np.arange(Nptheta)

        zp, rp, thetap = np.meshgrid(z_reg, r_reg, theta_reg,
                                     copy=True, indexing="ij")
        unalign_angles(thetap, Npz, Npr, method="random", rng=rng)
        r = rp.flatten()
        x = r * np.cos(thetap.flatten())
        y = r * np.sin(thetap.flatten())
        z = zp.flatten()
        w = n * r * dtheta * dr * dz
        if dens_func is not None:
            args = _check_dens_func_arguments(dens_func)
            if args == ["x", "y", "z"]:
                w = w * dens_func(x=x, y=y, z=z)
            else:
                w = w * dens_func(z=z, r=r)

        selected = w > 0
        Ntot = int(selected.sum())
        x, y, z, w = x[selected], y[selected], z[selected], w[selected]
        ux = ux_m * np.ones(Ntot) + ux_th * rng.normal(size=Ntot)
        uy = uy_m * np.ones(Ntot) + uy_th * rng.normal(size=Ntot)
        uz = uz_m * np.ones(Ntot) + uz_th * rng.normal(size=Ntot)
        inv_gamma = 1.0 / np.sqrt(1 + ux**2 + uy**2 + uz**2)
        return Ntot, x, y, z, ux, uy, uz, inv_gamma, w
    else:
        e = np.empty(0)
        return 0, e, e, e, e, e, e, e, e

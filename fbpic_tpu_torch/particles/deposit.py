"""Charge / current scatter deposition: particles -> grid.

Per-particle cell indices and shape weights are computed elementwise,
and all payload channels (azimuthal modes x re/im x components) of the
2x2 footprint are scattered at the base corner in ONE ``index_add_``
with a trailing channel axis; the corner offsets are then applied as
shifted adds on the grid and the guard cells are folded back (periodic
or clamped in z, reflected across the axis in r).

This is the path the exchange step uses to deposit a fresh rho_prev.
Shape factors include the Ruyten correction and the below-axis sign
flip (reference: deposition/particle_shapes.py:17-80,
fields/numba_methods.py:410-460).
"""
import torch

from ..constants import c
from .gather import _cylindrical_projection

# Guard cells on each side of the deposition buffer (enough for cubic)
NGUARD = 2


def _mode_phases(cos, sin, Nm):
    """Lists of (cos(m th), sin(m th)) for m = 0..Nm-1."""
    re_m, im_m = torch.ones_like(cos), torch.zeros_like(sin)
    res, ims = [re_m], [im_m]
    for _ in range(1, Nm):
        re_m, im_m = re_m * cos - im_m * sin, re_m * sin + im_m * cos
        res.append(re_m)
        ims.append(im_m)
    return res, ims


def _fold_guard_cells(buf, Nz, Nr, zfold="periodic"):
    """Fold a (Nz+4, Nr+4, C) deposition buffer into (Nz, Nr, C).

    z guards: periodic wrap (rows 0,1 -> Nz-2,Nz-1; rows Nz+2,Nz+3 ->
    0,1) or accumulation into the edge cells ('clamp', open boundaries).
    r guards: reflection across the axis (cols 0 -> ir=1, 1 -> ir=0) and
    clamping at rmax (cols Nr+2, Nr+3 -> ir=Nr-1).
    """
    g = NGUARD
    core_z = buf[g:Nz + g].clone()
    if zfold == "periodic":
        core_z[Nz - 2] += buf[0]
        core_z[Nz - 1] += buf[1]
        core_z[0] += buf[Nz + 2]
        core_z[1] += buf[Nz + 3]
    elif zfold == "clamp":
        core_z[0] += buf[0] + buf[1]
        core_z[Nz - 1] += buf[Nz + 2] + buf[Nz + 3]
    else:
        raise ValueError(zfold)
    out = core_z[:, g:Nr + g].clone()
    out[:, 1] += core_z[:, 0]
    out[:, 0] += core_z[:, 1]
    out[:, Nr - 1] += core_z[:, Nr + 2] + core_z[:, Nr + 3]
    return out


def _geometry(x, y, z, invdz, zmin, Nz, invdr, rmin, Nr, ruyten,
              comp=None):
    """Linear-shape geometry: corner indices, weights, angles.

    Radial lower-corner weights are per mode-row (mode 0 vs higher) with
    the Ruyten correction, plus the below-axis flag used for sign flips.
    """
    r, cos, sin = _cylindrical_projection(x, y)
    rdt = x.dtype
    r_cell = invdr * (r - rmin) - 0.5
    z_cell = invdz * (z - zmin) - 0.5

    iz_low = torch.ceil(z_cell).long() - 1
    sz1 = z_cell - iz_low.to(rdt)
    ir_low = torch.ceil(r_cell).long() - 1
    u = r_cell - ir_low.to(rdt)
    if comp is not None:
        # Kahan residuals folded into the SUB-CELL offsets (O(1)
        # numbers), after the big z_cell - iz_low cancellation
        cx, cy, cz = comp
        sz1 = sz1 + invdz * cz
        u = u + invdr * ((x * cx + y * cy) / torch.clamp(r, min=1e-30))
    sz0 = 1.0 - sz1
    bn_idx = torch.clamp(torch.ceil(r_cell).long(), 0, Nr)
    base0 = 1.0 - u
    corr = (1.0 - u) * u
    sr0_m0 = base0 + ruyten[0][bn_idx] * corr
    sr0_mh = base0 + ruyten[1][bn_idx] * corr
    below_axis = ir_low < 0

    Nzb, Nrb = Nz + 2 * NGUARD, Nr + 2 * NGUARD
    # Clip stragglers into the guard rows instead of wrapping
    iz_buf = torch.clamp(iz_low + NGUARD, 0, Nz + NGUARD)
    ir_buf = torch.clamp(ir_low + NGUARD, max=Nr + NGUARD)
    return dict(cos=cos, sin=sin, below_axis=below_axis,
                sz0=sz0, sz1=sz1, sr0_m0=sr0_m0, sr0_mh=sr0_mh,
                idx00=iz_buf * Nrb + ir_buf, Nzb=Nzb, Nrb=Nrb)


def _deposit_channels(geom, channel_vals, meta, Nzb, Nrb, Nz, Nr, zfold):
    """Scatter all channels at once; channel_vals (Np, C).
    Returns the folded (Nz, Nr, C) real tensor."""
    sz0, sz1 = geom["sz0"], geom["sz1"]
    below = geom["below_axis"]
    sr0 = torch.where(meta["is_mode0"][None, :], geom["sr0_m0"][:, None],
                      geom["sr0_mh"][:, None])           # (Np, C)
    sr1 = 1.0 - sr0
    sr0 = torch.where(below[:, None], meta["flip"][None, :] * sr0, sr0)

    v = channel_vals
    vals = torch.cat([v * (sz0[:, None] * sr0), v * (sz0[:, None] * sr1),
                      v * (sz1[:, None] * sr0), v * (sz1[:, None] * sr1)],
                     dim=1)                              # (Np, 4C)
    C = v.shape[1]
    buf = torch.zeros((Nzb * Nrb, 4 * C), dtype=v.dtype, device=v.device)
    buf.index_add_(0, geom["idx00"], vals)
    buf = buf.reshape(Nzb, Nrb, 4, C)

    out = buf[:, :, 0, :].clone()
    out[:, 1:, :] += buf[:, :-1, 1, :]                   # (iz, ir+1)
    out[1:, :, :] += buf[:-1, :, 2, :]                   # (iz+1, ir)
    out[1:, 1:, :] += buf[:-1, :-1, 3, :]                # (iz+1, ir+1)
    return _fold_guard_cells(out, Nz, Nr, zfold)


def _channel_meta(Nm, n_components, comp_flip_parity, dtype, device):
    """Per-channel metadata for (component, mode, re/im) channels.

    Channel layout: comp-major, then mode, then re/im -- except that the
    identically-zero mode-0 imaginary part is not stored, so each
    component spans 2*Nm - 1 channels.
    """
    is_mode0, flip = [], []
    for comp in range(n_components):
        for m in range(Nm):
            msign = 1.0 if m % 2 == 0 else -1.0
            for _part in range(1 if m == 0 else 2):
                is_mode0.append(m == 0)
                flip.append(comp_flip_parity[comp] * msign)
    return dict(is_mode0=torch.tensor(is_mode0, device=device),
                flip=torch.tensor(flip, dtype=dtype, device=device))


def _pack_channels(values, Nm, dim):
    """Pack per-component complex (Nm, ...) mode values into real
    channels stacked along `dim` (the zero mode-0 imag is not stored)."""
    cols = []
    for val in values:
        for m in range(Nm):
            cols.append(val[m].real)
            if m > 0:
                cols.append(val[m].imag)
    return torch.stack(cols, dim=dim)


def _unpack_channels(arr, n_components, Nm):
    """Unpack (Nz, Nr, C) channels into a list of complex (Nm, Nz, Nr)."""
    out = []
    i = 0
    for _comp in range(n_components):
        modes = []
        for m in range(Nm):
            if m == 0:
                modes.append(torch.complex(arr[:, :, i],
                                           torch.zeros_like(arr[:, :, i])))
                i += 1
            else:
                modes.append(torch.complex(arr[:, :, i], arr[:, :, i + 1]))
                i += 2
        out.append(torch.stack(modes))
    return out


def _modes(base, cos_m, sin_m):
    """Complex (Nm, ...) mode values base * e^{i m theta}."""
    return torch.stack([torch.complex(base * cm, base * sm)
                        for cm, sm in zip(cos_m, sin_m)])


def deposit_rho_linear(x, y, z, w, q, Nm, invdz, zmin, Nz, invdr, rmin, Nr,
                       ruyten_linear, zfold="periodic", comp=None):
    """Deposit charge density (not yet divided by cell volume).
    Returns complex (Nm, Nz, Nr)."""
    geom = _geometry(x, y, z, invdz, zmin, Nz, invdr, rmin, Nr,
                     ruyten_linear, comp=comp)
    cos_m, sin_m = _mode_phases(geom["cos"], geom["sin"], Nm)
    channels = _pack_channels([_modes(q * w, cos_m, sin_m)], Nm, dim=1)
    meta = _channel_meta(Nm, 1, [+1.0], x.dtype, x.device)
    out = _deposit_channels(geom, channels, meta, geom["Nzb"],
                            geom["Nrb"], Nz, Nr, zfold)
    return _unpack_channels(out, 1, Nm)[0]


def current_components(wj, cos, sin, ux, uy, uz, inv_gamma):
    """Per-particle (jr, jt, jz) before the azimuthal mode phases."""
    return (wj * c * inv_gamma * (cos * ux + sin * uy),
            wj * c * inv_gamma * (cos * uy - sin * ux),
            wj * c * inv_gamma * uz)


def deposit_J_linear(x, y, z, w, q, ux, uy, uz, inv_gamma, Nm,
                     invdz, zmin, Nz, invdr, rmin, Nr, ruyten_linear,
                     zfold="periodic", comp=None):
    """Deposit current density; returns (Jr, Jt, Jz) complex (Nm, Nz, Nr)."""
    geom = _geometry(x, y, z, invdz, zmin, Nz, invdr, rmin, Nr,
                     ruyten_linear, comp=comp)
    cos, sin = geom["cos"], geom["sin"]
    cos_m, sin_m = _mode_phases(cos, sin, Nm)
    js = current_components(q * w, cos, sin, ux, uy, uz, inv_gamma)
    channels = _pack_channels([_modes(j0, cos_m, sin_m) for j0 in js],
                              Nm, dim=1)
    # Jr/Jt flip with -(-1)^m below the axis; Jz with (-1)^m
    meta = _channel_meta(Nm, 3, [-1.0, -1.0, +1.0], x.dtype, x.device)
    out = _deposit_channels(geom, channels, meta, geom["Nzb"],
                            geom["Nrb"], Nz, Nr, zfold)
    return tuple(_unpack_channels(out, 3, Nm))

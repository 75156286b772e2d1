"""Sorted deposition: particles -> grid on the column-padded layout.

Particles are sorted by their z grid column and each column's slots are
padded to a static capacity K (``build_column_sort``, or the per-step
``banded_column_resort`` of an already sorted layout).  Each deposit
then computes all shape weights (Ruyten-corrected radial corners,
below-axis flips, azimuthal mode phases, the z edge mask) as per-slot
channel vectors V and sums them per (column, radial row):

    out[col, ir, ch] = sum_k [ir_buf(col, k) == ir] * V[col, k, ch]

Positions drift by at most c*dt/2 between the sort and each deposit, so
the true z cell differs from the sort column by a small bounded offset;
the offsets are extra channel blocks in V and shifted adds on the grid.

The result equals the scatter path (deposit.py) in exact arithmetic --
same shape factors, folding and edge masking.  Cubic shapes
(``deposit_rho_J_sorted_cubic``) carry 4 radial corner blocks per z
offset and contract with the plain segmented sum ``_contract``
(index_add_): fbpic_tpu computes them with an XLA einsum, not a Pallas
kernel.  The fused J + d(rho)
contraction of the float32 path runs in K1
(``cuda_fused.fused_onehot_contract``); the J and rho contractions of
the ``with_rho`` branch and of ``deposit_J_sorted`` /
``deposit_rho_sorted`` (the legacy plan) run in K3
(``cuda_dense.dense_onehot_contract``).

Reference behavior being replaced: cell-sorted atomics on CUDA
(FBPIC's fbpic/particles/deposition/cuda_methods.py) and
per-thread buffer accumulation on CPU (threading_methods.py:28-455).
"""
import torch

from ..constants import c
from .gather import _cylindrical_projection
from .deposit import (
    NGUARD, _mode_phases, _channel_meta, _pack_channels, _unpack_channels,
    _fold_guard_cells, _modes, current_components, _cubic_axis_weights,
    _kahan_cells, cubic_radial_rows, cubic_shape,
)
from .cuda_fused import fused_onehot_contract
from .cuda_dense import dense_onehot_contract


def build_column_sort(z, w, zmin, invdz, Nz, K, payload=None):
    """Sort particles by z grid column and pad each column to K slots.

    Every live particle (w != 0) enters the plan; out-of-box particles
    are clamped to the edge columns.  Dead particles sort last and never
    enter the plan.  ``payload``: tuple of (Np,) tensors carried through
    the sort; they come back padded to (Nz, K) under ``padded``.  Slots
    past a column's count hold the next particles of the sorted order
    (masked by ``valid``).  Without a payload the plan is the legacy one:
    ``idx``, the (Nz, K) particle index of every slot, through which
    ``deposit_rho_sorted`` / ``deposit_J_sorted`` gather the arrays as
    they are when they deposit.  Columns holding more than K live
    particles drop the excess; the count is returned in ``n_over``.

    The sort is stable, so the layout matches fbpic_tpu's ``lax.sort``
    exactly.
    """
    Np = z.shape[0]
    col = torch.clamp(torch.floor(invdz * (z - zmin)).long(), 0, Nz - 1)
    key = torch.where(w != 0, col, torch.full_like(col, Nz))
    keys_sorted, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        keys_sorted, torch.arange(Nz + 1, device=z.device))
    pos = starts[:Nz, None] + torch.arange(K, device=z.device)[None, :]
    valid = pos < starts[1:Nz + 1, None]
    counts = starts[1:Nz + 1] - starts[:Nz]
    n_over = torch.clamp(counts - K, min=0).sum()
    if payload is None:
        idx = (perm[torch.clamp(pos, 0, Np - 1)] if Np
               else torch.zeros_like(pos))
        return dict(idx=idx, valid=valid, n_over=n_over)
    padded = [None] * len(payload)
    groups = {}
    for i, arr in enumerate(payload):
        groups.setdefault(arr.dtype, []).append(i)
    for dt, idxs in groups.items():
        S = torch.stack([payload[i] for i in idxs])[:, perm]   # (Cg, Np)
        S = torch.cat([S, torch.zeros((len(idxs), K), dtype=dt,
                                      device=z.device)], dim=1)
        G = S[:, pos]                                          # (Cg, Nz, K)
        for j, i in enumerate(idxs):
            padded[i] = G[j]
    return dict(valid=valid, n_over=n_over, padded=padded)


def banded_column_resort(padded, zmin, invdz, Nz, K, band,
                         zfold="periodic"):
    """Per-step re-sort of an already column-aligned padded layout.

    ``padded``: list of (Nz, K) channels in build_column_sort payload
    order (z is channel 2, w channel 3).  The layout was the exact
    column sort one step ago (rolled with the moving window), so every
    live particle's current column lies within ``band`` rows of its
    stored row.  Candidates for destination row d are the slots of rows
    d-band .. d+band, kept where their (clamped) current column maps to
    d, and compacted by one row-wise sort of the lane index.

    Escapees one row past the band (a float32 cell-edge coordinate
    rounding across an integer) are clamped into the nearest in-band
    row.  ``n_over`` counts kept candidates beyond K per row plus live
    particles left unplaced.  Ported from fbpic_tpu's code; its
    periodic-seam behaviour for Nz <= 4*band + 2 is the reference's.
    """
    z, w = padded[2], padded[3]
    dev = z.device
    col = torch.clamp(torch.floor(invdz * (z - zmin)).long(), 0, Nz - 1)
    live = w != 0
    M = (2 * band + 1) * K

    def expand(a):
        return torch.cat([torch.roll(a, -o, dims=0)
                          for o in range(-band, band + 1)], dim=1)

    dest = torch.arange(Nz, device=dev)[:, None]
    delta = expand(col) - dest
    if zfold == "periodic":
        delta = torch.remainder(delta + Nz // 2, Nz) - Nz // 2
    off = torch.arange(-band, band + 1, device=dev).repeat_interleave(K)
    kept = expand(live) & (torch.clamp(delta - off[None, :], -band, band)
                           == -off[None, :])
    if zfold != "periodic":
        origin = dest + off[None, :]
        kept = kept & (origin >= 0) & (origin < Nz)
    lanes = torch.arange(M, device=dev)[None, :]
    key = torch.where(kept, lanes, torch.full_like(lanes, M))
    lane = torch.sort(key, dim=1).values[:, :K]
    valid = lane < M
    lane_c = torch.where(valid, lane, torch.zeros_like(lane))
    src_row = torch.remainder(dest + (lane_c // K - band), Nz)
    flat = (src_row * K + lane_c % K).reshape(-1)
    new_padded = [torch.where(valid, a.reshape(-1)[flat].reshape(Nz, K),
                              torch.zeros((), dtype=a.dtype, device=dev))
                  for a in padded]
    n_col_over = torch.clamp(kept.sum(dim=1) - K, min=0).sum()
    n_unplaced = live.sum() - kept.sum()
    return dict(padded=new_padded, valid=valid,
                n_over=n_col_over + n_unplaced)


def _padded_arrays(sort, arrays):
    """`arrays` in the plan's padded (Nz, K) form: a payload plan's
    pre-padded channels (the caller's arrays must follow the payload
    order), or the arrays gathered through a legacy plan's ``idx``."""
    if "idx" in sort:
        if arrays[0].shape[0] == 0:      # no particles: every slot invalid
            return [torch.zeros(sort["idx"].shape, dtype=a.dtype,
                                device=a.device) for a in arrays]
        return list(torch.stack(arrays)[:, sort["idx"]].unbind(0))
    padded = sort["padded"]
    if len(arrays) > len(padded):
        raise ValueError("more arrays than payload channels in the plan")
    return padded[:len(arrays)]


def _padded_geometry(sort, x, y, z, invdz, zmin, Nz, invdr, rmin, Nr,
                     ruyten, zfold, delta_lo, delta_hi, comp=None):
    """Linear-shape geometry on the padded (Nz, K) layout.

    Mirrors deposit._geometry (same Ruyten rows, below-axis flag,
    straggler clipping) but returns the z contribution as per-offset
    weights zw[o] relative to the sort column.
    """
    r, cos, sin = _cylindrical_projection(x, y)
    rdt = x.dtype
    r_cell = invdr * (r - rmin) - 0.5
    z_cell = invdz * (z - zmin) - 0.5

    iz_low = torch.ceil(z_cell).long() - 1
    sz1 = z_cell - iz_low.to(rdt)
    if comp is not None:
        cx, cy, cz = comp
        sz1 = sz1 + invdz * cz
    sz0 = 1.0 - sz1
    ok = sort["valid"].to(rdt)
    sz0 = sz0 * ok
    sz1 = sz1 * ok

    # Offset of the true z cell from the sort column: clipped for open z
    # (stragglers go to the guard rows like the scatter path), wrapped
    # for periodic z
    col = torch.arange(Nz, device=x.device)[:, None]
    if zfold == "clamp":
        delta = torch.clamp(torch.clamp(iz_low, -NGUARD, Nz) - col,
                            delta_lo, delta_hi)
    else:
        delta = torch.remainder(iz_low - col - delta_lo, Nz) + delta_lo
    zw = [sz0 * (delta == o) + sz1 * (delta == o - 1)
          for o in range(delta_lo, delta_hi + 2)]

    ir_low = torch.ceil(r_cell).long() - 1
    u = r_cell - ir_low.to(rdt)
    if comp is not None:
        u = u + invdr * ((x * cx + y * cy) / torch.clamp(r, min=1e-30))
    bn_idx = torch.clamp(torch.ceil(r_cell).long(), 0, Nr)
    base0 = 1.0 - u
    corr = (1.0 - u) * u
    sr0_m0 = base0 + ruyten[0][bn_idx] * corr
    sr0_mh = base0 + ruyten[1][bn_idx] * corr
    return dict(cos=cos, sin=sin, below_axis=ir_low < 0,
                zw=zw, sr0_m0=sr0_m0, sr0_mh=sr0_mh,
                ir_buf=torch.clamp(ir_low + NGUARD, max=Nr + NGUARD),
                ir_low=ir_low, u=u, bn_idx=bn_idx,
                s_sub=sz1, delta=delta, ok=ok)


def _build_V(geom, channel_vals, meta):
    """Channel blocks [(Nz, K, C)] * (n_off*2) of one deposit."""
    sr0 = torch.where(meta["is_mode0"][None, None, :],
                      geom["sr0_m0"][:, :, None], geom["sr0_mh"][:, :, None])
    sr1 = 1.0 - sr0
    sr0 = torch.where(geom["below_axis"][:, :, None],
                      meta["flip"][None, None, :] * sr0, sr0)
    blocks = []
    for zw in geom["zw"]:
        zwv = channel_vals * zw[:, :, None]
        blocks.append(zwv * sr0)
        blocks.append(zwv * sr1)
    return blocks


def _build_V_span_diff(span, dph, ph_b, wj, meta, ruyten, n_blocks=5):
    """V of the telescoped difference deposit (see deposit_rho_J_sorted);
    dph = ph_b - ph_a."""
    def radial_corners(u):
        corr = (1.0 - u) * u
        sr0_m0 = (1.0 - u) + ruyten[0][span["bn"]] * corr
        sr0_mh = (1.0 - u) + ruyten[1][span["bn"]] * corr
        sr0 = torch.where(meta["is_mode0"][None, None, :],
                          sr0_m0[:, :, None], sr0_mh[:, :, None])
        sr1 = 1.0 - sr0
        sr0 = torch.where(span["below"][:, :, None],
                          meta["flip"][None, None, :] * sr0, sr0)
        return sr0, sr1

    sr0_a, sr1_a = radial_corners(span["u_a"])
    sr0_b, sr1_b = radial_corners(span["u_b"])
    dsr0 = sr0_b - sr0_a
    dsr1 = sr1_b - sr1_a
    wj3 = wj[:, :, None]
    blocks = []
    for o in range(n_blocks):
        zw_a = span["zw_a"][o][:, :, None]
        zw_b = span["zw_b"][o][:, :, None]
        dzw = zw_b - zw_a
        blocks.append(wj3 * (dph * (zw_a * sr0_a) + ph_b * (dzw * sr0_a)
                             + ph_b * (zw_b * dsr0)))
        blocks.append(wj3 * (dph * (zw_a * sr1_a) + ph_b * (dzw * sr1_a)
                             + ph_b * (zw_b * dsr1)))
    return blocks


def _contract(ir_buf, blocks, Nrb):
    """Segmented sum out[col, r, ch] = sum_k [ir_buf[col, k] == r]
    V[col, k, ch] with V = concat(blocks, axis=2): one index_add_ a block
    into its own channel columns (a concatenated V of a few channels a
    block costs the card more to copy than to sum)."""
    Nz = ir_buf.shape[0]
    W = sum(b.shape[2] for b in blocks)
    dtype, dev = blocks[0].dtype, blocks[0].device
    col = torch.arange(Nz, device=dev)[:, None]
    seg = (col * Nrb + ir_buf).reshape(-1)
    out = torch.zeros((Nz * Nrb, W), dtype=dtype, device=dev)
    a = 0
    for b in blocks:
        C = b.shape[2]
        out[:, a:a + C].index_add_(0, seg, b.reshape(-1, C))
        a += C
    return out.reshape(Nz, Nrb, W)


def _add_shifted_plane(buf, plane, lo, Nz, Nzb, zfold):
    """Add a (Nz, Nrb, C) plane into buf (in place) at z-row offset `lo`.

    Rows pushed out of the (Nzb,) buffer wrap around the seam for
    periodic z; for open z ('clamp') they are empty by construction and
    dropped like the scatter path's guard-row clip."""
    if lo >= 0 and lo + Nz <= Nzb:
        buf[lo:lo + Nz] += plane
    elif lo < 0:
        buf[:lo + Nz] += plane[-lo:]
        if zfold == "periodic":
            buf[Nz + lo:Nz] += plane[:-lo]
    else:
        buf[lo:] += plane[:Nzb - lo]
        if zfold == "periodic":
            buf[Nzb - Nz:lo] += plane[Nzb - lo:]
    return buf


def _reassemble(out, Nz, Nr, zfold, delta_lo, delta_hi, C):
    """Shifted adds of the (Nz, Nrb, n_off*2*C) contraction output
    into the folded (Nz, Nr, C) grid."""
    Nzb, Nrb = Nz + 2 * NGUARD, Nr + 2 * NGUARD
    n_off = delta_hi + 2 - delta_lo
    out = out.reshape(Nz, Nrb, n_off, 2, C)
    buf = torch.zeros((Nzb, Nrb, C), dtype=out.dtype, device=out.device)
    for i, o in enumerate(range(delta_lo, delta_hi + 2)):
        plane = out[:, :, i, 0, :].clone()
        plane[:, 1:, :] += out[:, :-1, i, 1, :]
        _add_shifted_plane(buf, plane, o + NGUARD, Nz, Nzb, zfold)
    return _fold_guard_cells(buf, Nz, Nr, zfold)


def _dense_deposit(geom, channel_vals, meta, Nz, Nr, zfold,
                   delta_lo, delta_hi):
    """Segmented sum of the padded channels (Nz, K, C) by radial row
    (K3).  Returns the folded (Nz, Nr, C) grid."""
    out = dense_onehot_contract(geom, channel_vals, meta, Nr + 2 * NGUARD)
    return _reassemble(out, Nz, Nr, zfold, delta_lo, delta_hi,
                       channel_vals.shape[2])


def _pack_padded(values, Nm):
    """Complex (Nm, Nz, K) per component -> real (Nz, K, C) channels."""
    return _pack_channels(values, Nm, dim=2)


def deposit_rho_sorted(sort, x, y, z, w, q, Nm, invdz, zmin, Nz, invdr,
                       rmin, Nr, ruyten_linear, zfold="periodic"):
    """Sorted counterpart of deposit.deposit_rho_linear on a plan built
    at most half a push away from the deposit positions (z offsets
    -2..2), one K3 contraction.  As in fbpic_tpu, the Kahan words do not
    enter.  Returns complex (Nm, Nz, Nr)."""
    x, y, z, w = _padded_arrays(sort, [x, y, z, w])
    geom = _padded_geometry(sort, x, y, z, invdz, zmin, Nz, invdr, rmin,
                            Nr, ruyten_linear, zfold, delta_lo=-2,
                            delta_hi=1)
    cos_m, sin_m = _mode_phases(geom["cos"], geom["sin"], Nm)
    channels = _pack_padded([_modes(q * w, cos_m, sin_m)], Nm)
    meta = _channel_meta(Nm, 1, [+1.0], x.dtype, x.device)
    out = _dense_deposit(geom, channels, meta, Nz, Nr, zfold,
                         delta_lo=-2, delta_hi=1)
    return _unpack_channels(out, 1, Nm)[0]


def deposit_J_sorted(sort, x, y, z, w, q, ux, uy, uz, inv_gamma, Nm,
                     invdz, zmin, Nz, invdr, rmin, Nr, ruyten_linear,
                     zfold="periodic"):
    """Sorted counterpart of deposit.deposit_J_linear (the window of
    fbpic_tpu's: z offsets -2..2), one K3 contraction.  Returns
    (Jr, Jt, Jz) complex (Nm, Nz, Nr)."""
    x, y, z, w, ux, uy, uz, inv_gamma = _padded_arrays(
        sort, [x, y, z, w, ux, uy, uz, inv_gamma])
    geom = _padded_geometry(sort, x, y, z, invdz, zmin, Nz, invdr, rmin,
                            Nr, ruyten_linear, zfold, delta_lo=-2,
                            delta_hi=1)
    cos, sin = geom["cos"], geom["sin"]
    cos_m, sin_m = _mode_phases(cos, sin, Nm)
    js = current_components(q * w, cos, sin, ux, uy, uz, inv_gamma)
    channels = _pack_padded([_modes(j0, cos_m, sin_m) for j0 in js], Nm)
    meta = _channel_meta(Nm, 3, [-1.0, -1.0, +1.0], x.dtype, x.device)
    out = _dense_deposit(geom, channels, meta, Nz, Nr, zfold,
                         delta_lo=-2, delta_hi=1)
    return tuple(_unpack_channels(out, 3, Nm))


def deposit_rho_J_sorted(sort, x, y, z, w, q, ux, uy, uz, inv_gamma,
                         dt_half, Nm, invdz, zmin, Nz, invdr, rmin, Nr,
                         ruyten_linear, zfold="periodic", comp=None,
                         with_drho=False, with_rho=True,
                         sort_at_start=False, vz_shift=0.0):
    """Fused J (at the current positions) + rho (at the positions one
    half push later) + optionally d(rho), on the padded layout.

    sort_at_start: the plan was built half a push before the current
    (J) positions (the resident step sorts at the start of the step), so
    every z offset window widens by one cell each way.

    vz_shift: the Galilean grid speed v_comoving.  ``zmin`` is then the
    grid edge at the J time; the rho / d(rho) endpoints move relative to
    a grid that itself flows, at the effective z velocity vz - vz_shift
    (covered by the offset windows under c*dt <= dz).

    Returns (Jr, Jt, Jz, rho) raw grids (not divided by cell volume),
    plus drho when ``with_drho``; rho is None when not ``with_rho``.
    """
    dj_lo, dj_hi = (-2, 1) if sort_at_start else (-1, 0)
    dr_lo, dr_hi = (-3, 2) if sort_at_start else (-2, 1)
    x, y, z, w, ux, uy, uz, inv_gamma, comp = _padded_particles(
        sort, x, y, z, w, ux, uy, uz, inv_gamma, comp)

    # --- J at the current (n+1/2) positions
    geom, channels, meta, wj = _J_operands(
        sort, x, y, z, w, q, ux, uy, uz, inv_gamma, Nm, invdz, zmin, Nz,
        invdr, rmin, Nr, ruyten_linear, zfold, dj_lo, dj_hi, comp)
    chdt = c * dt_half
    if not with_drho:
        out = _dense_deposit(geom, channels, meta, Nz, Nr, zfold,
                             delta_lo=dj_lo, delta_hi=dj_hi)
        Jr, Jt, Jz = _unpack_channels(out, 3, Nm)

    # --- rho at the half-pushed (n+1) positions (skipped when the
    # caller derives rho_next = rho_prev + drho)
    rho = None
    if with_rho:
        geom2, channels2, meta2 = _rho_operands(
            sort, x, y, z, wj, ux, uy, uz, inv_gamma, chdt,
            vz_shift * dt_half, Nm, invdz, zmin, Nz, invdr, rmin, Nr,
            ruyten_linear, zfold, dr_lo, dr_hi, comp)
        out2 = _dense_deposit(geom2, channels2, meta2, Nz, Nr, zfold,
                              delta_lo=dr_lo, delta_hi=dr_hi)
        rho = _unpack_channels(out2, 1, Nm)[0]
    if not with_drho:
        return Jr, Jt, Jz, rho

    # --- drho = rho(x_{n+1}) - rho(x_n), in ONE contraction with J
    # (they share the mid-position rows): K1
    span, dph, ph_b, n_offD = _drho_operands(
        geom, x, y, w, ux, uy, uz, inv_gamma, chdt, invdz, invdr, Nm,
        dj_lo, dj_hi, vz_shift * dt_half)
    n_offJ = dj_hi + 2 - dj_lo
    W_J = n_offJ * 2 * channels.shape[2]
    out_all = fused_onehot_contract(
        geom, channels, meta, span, dph, ph_b, wj, ruyten_linear,
        Nm, Nz, Nr, n_offJ=n_offJ, n_offD=n_offD)
    out_J = _reassemble(out_all[..., :W_J], Nz, Nr, zfold, dj_lo, dj_hi,
                        channels.shape[2])
    Jr, Jt, Jz = _unpack_channels(out_J, 3, Nm)
    out_D = _reassemble(out_all[..., W_J:], Nz, Nr, zfold,
                        dj_lo - 1, dj_hi + 1, dph.shape[2])
    drho = _unpack_channels(out_D, 1, Nm)[0]
    return Jr, Jt, Jz, rho, drho


def _padded_particles(sort, x, y, z, w, ux, uy, uz, inv_gamma, comp):
    """The plan's padded particle channels (+ Kahan words if any)."""
    if comp is not None:
        (x, y, z, w, ux, uy, uz, inv_gamma,
         cx, cy, cz) = _padded_arrays(
            sort, [x, y, z, w, ux, uy, uz, inv_gamma] + list(comp))
        return x, y, z, w, ux, uy, uz, inv_gamma, (cx, cy, cz)
    x, y, z, w, ux, uy, uz, inv_gamma = _padded_arrays(
        sort, [x, y, z, w, ux, uy, uz, inv_gamma])
    return x, y, z, w, ux, uy, uz, inv_gamma, None


def _J_operands(sort, x, y, z, w, q, ux, uy, uz, inv_gamma, Nm, invdz,
                zmin, Nz, invdr, rmin, Nr, ruyten, zfold, dj_lo, dj_hi,
                comp):
    """Geometry, packed channels, channel metadata and q*w of the J
    deposit at the current positions."""
    geom = _padded_geometry(sort, x, y, z, invdz, zmin, Nz, invdr, rmin,
                            Nr, ruyten, zfold, delta_lo=dj_lo,
                            delta_hi=dj_hi, comp=comp)
    cos, sin = geom["cos"], geom["sin"]
    cos_m, sin_m = _mode_phases(cos, sin, Nm)
    wj = q * w
    js = current_components(wj, cos, sin, ux, uy, uz, inv_gamma)
    channels = _pack_padded([_modes(j0, cos_m, sin_m) for j0 in js], Nm)
    meta = _channel_meta(Nm, 3, [-1.0, -1.0, +1.0], x.dtype, x.device)
    return geom, channels, meta, wj


def _rho_operands(sort, x, y, z, wj, ux, uy, uz, inv_gamma, chdt, z_shift,
                  Nm, invdz, zmin, Nz, invdr, rmin, Nr, ruyten, zfold,
                  dr_lo, dr_hi, comp):
    """Geometry, packed channels and channel metadata of the rho deposit
    at the positions one half push later (z_shift: the Galilean grid's
    drift over that half push)."""
    x2 = x + chdt * inv_gamma * ux
    y2 = y + chdt * inv_gamma * uy
    z2 = z + chdt * inv_gamma * uz - z_shift
    geom2 = _padded_geometry(sort, x2, y2, z2, invdz, zmin, Nz, invdr, rmin,
                             Nr, ruyten, zfold, delta_lo=dr_lo,
                             delta_hi=dr_hi, comp=comp)
    cos_m2, sin_m2 = _mode_phases(geom2["cos"], geom2["sin"], Nm)
    channels2 = _pack_padded([_modes(wj, cos_m2, sin_m2)], Nm)
    meta2 = _channel_meta(Nm, 1, [+1.0], x.dtype, x.device)
    return geom2, channels2, meta2


def _drho_operands(geom, x, y, w, ux, uy, uz, inv_gamma, chdt, invdz,
                   invdr, Nm, dj_lo, dj_hi, z_shift=0.0):
    """Endpoint data of the telescoped d(rho) deposit (z_shift: the
    Galilean grid's drift over half a step).

    Endpoint shapes derive from the MID-position geometry plus
    velocity-product half-step deltas in cell units (materialized
    float32 endpoint coordinates would re-quantize the positions at the
    cell-coordinate ULP, larger than the per-step density change).
    Cell-boundary crossers go to the right offset block by
    floor-splitting (exact in z).  Returns (span, dph, ph_b, n_offD)."""
    hz = (chdt * inv_gamma * uz - z_shift) * invdz
    vr = geom["cos"] * ux + geom["sin"] * uy
    hr = chdt * inv_gamma * vr * invdr
    s_mid, delta_mid, ok = geom["s_sub"], geom["delta"], geom["ok"]
    o_range = range(dj_lo - 1, dj_hi + 3)

    def z_blocks(s_shift):
        sp_ = s_mid + s_shift
        shift = torch.floor(sp_)
        s = sp_ - shift
        d = delta_mid + shift.long()
        s0 = (1.0 - s) * ok
        s1 = s * ok
        return [s0 * (d == o) + s1 * (d == o - 1) for o in o_range]

    zw_a = z_blocks(-hz)
    zw_b = z_blocks(hz)

    # Endpoint phases from the endpoint coordinates (phase differences
    # are small relative to their O(1) inputs)
    x0e, y0e = x - chdt * inv_gamma * ux, y - chdt * inv_gamma * uy
    x2e, y2e = x + chdt * inv_gamma * ux, y + chdt * inv_gamma * uy
    r0e = torch.clamp(torch.sqrt(x0e * x0e + y0e * y0e), min=1e-30)
    r2e = torch.clamp(torch.sqrt(x2e * x2e + y2e * y2e), min=1e-30)
    cma, sma = _mode_phases(x0e / r0e, y0e / r0e, Nm)
    cmb, smb = _mode_phases(x2e / r2e, y2e / r2e, Nm)
    one = torch.ones_like(w)
    ph_a = _pack_padded([_modes(one, cma, sma)], Nm)
    ph_b = _pack_padded([_modes(one, cmb, smb)], Nm)
    span = dict(zw_a=zw_a, zw_b=zw_b,
                u_a=geom["u"] - hr, u_b=geom["u"] + hr,
                bn=geom["bn_idx"], ir_buf=geom["ir_buf"],
                below=geom["below_axis"])
    return span, ph_b - ph_a, ph_b, len(o_range)


def fused_contract_operands(sort, x, y, z, w, q, ux, uy, uz, inv_gamma,
                            dt_half, Nm, invdz, zmin, Nz, invdr, rmin, Nr,
                            ruyten_linear, zfold="periodic", comp=None,
                            sort_at_start=False):
    """The keyword arguments of K1 (``fused_onehot_contract``) exactly
    as ``deposit_rho_J_sorted(with_drho=True)`` builds them."""
    dj_lo, dj_hi = (-2, 1) if sort_at_start else (-1, 0)
    x, y, z, w, ux, uy, uz, inv_gamma, comp = _padded_particles(
        sort, x, y, z, w, ux, uy, uz, inv_gamma, comp)
    geom, channels, meta, wj = _J_operands(
        sort, x, y, z, w, q, ux, uy, uz, inv_gamma, Nm, invdz, zmin, Nz,
        invdr, rmin, Nr, ruyten_linear, zfold, dj_lo, dj_hi, comp)
    span, dph, ph_b, n_offD = _drho_operands(
        geom, x, y, w, ux, uy, uz, inv_gamma, c * dt_half, invdz, invdr,
        Nm, dj_lo, dj_hi)
    return dict(geom=geom, channels=channels, meta=meta, span=span,
                dph=dph, ph_b=ph_b, wj=wj, ruyten=ruyten_linear, Nm=Nm,
                Nz=Nz, Nr=Nr, n_offJ=dj_hi + 2 - dj_lo, n_offD=n_offD)


def dense_contract_operands(sort, x, y, z, w, q, ux, uy, uz, inv_gamma,
                            dt_half, Nm, invdz, zmin, Nz, invdr, rmin, Nr,
                            ruyten_linear, zfold="periodic", comp=None,
                            sort_at_start=False, vz_shift=0.0):
    """The keyword arguments of the two ``_dense_deposit`` calls (K3) of
    ``deposit_rho_J_sorted(with_rho=True)``, exactly as it builds them:
    {"J": ..., "rho": ...}.  K3 itself takes (geom, channel_vals, meta)
    with Nrb = Nr + 2 * NGUARD."""
    dj_lo, dj_hi = (-2, 1) if sort_at_start else (-1, 0)
    dr_lo, dr_hi = (-3, 2) if sort_at_start else (-2, 1)
    x, y, z, w, ux, uy, uz, inv_gamma, comp = _padded_particles(
        sort, x, y, z, w, ux, uy, uz, inv_gamma, comp)
    geom, channels, meta, wj = _J_operands(
        sort, x, y, z, w, q, ux, uy, uz, inv_gamma, Nm, invdz, zmin, Nz,
        invdr, rmin, Nr, ruyten_linear, zfold, dj_lo, dj_hi, comp)
    geom2, channels2, meta2 = _rho_operands(
        sort, x, y, z, wj, ux, uy, uz, inv_gamma, c * dt_half,
        vz_shift * dt_half, Nm, invdz, zmin, Nz, invdr, rmin, Nr,
        ruyten_linear, zfold, dr_lo, dr_hi, comp)
    common = dict(Nz=Nz, Nr=Nr, zfold=zfold)
    return dict(
        J=dict(geom=geom, channel_vals=channels, meta=meta,
               delta_lo=dj_lo, delta_hi=dj_hi, **common),
        rho=dict(geom=geom2, channel_vals=channels2, meta=meta2,
                 delta_lo=dr_lo, delta_hi=dr_hi, **common))


# ---------------------------------------------------------------------
# Cubic (third-order) shapes on the sorted layout: the same design as
# the linear path with a 4x4 footprint -- 4 radial corner planes ride as
# channel blocks (reassembled by radial shifts) and z uses 4-point
# per-offset weight blocks.  The contraction is _contract (index_add_).
# ---------------------------------------------------------------------

def _padded_geometry_cubic(sort, x, y, z, invdz, zmin, Nz, invdr, rmin,
                           Nr, ruyten_cubic, zfold, delta_lo, delta_hi,
                           comp=None):
    """Cubic-shape geometry on the padded (Nz, K) layout: mirrors
    deposit._geometry_cubic, with the z contribution as per-offset
    weight blocks zw[o] relative to the sort column."""
    r, cos, sin = _cylindrical_projection(x, y)
    rdt = x.dtype
    r_cell = invdr * (r - rmin) - 0.5
    z_cell = invdz * (z - zmin) - 0.5
    ez, er = _kahan_cells(x, y, r, comp, invdz, invdr)
    iz_low, uz_, sz = _cubic_axis_weights(z_cell, extra=ez)
    ir_low, u, sr_plain = _cubic_axis_weights(r_cell, extra=er)
    ok = sort["valid"].to(rdt)
    sz = tuple(s_ * ok for s_ in sz)

    col = torch.arange(Nz, device=x.device)[:, None]
    if zfold == "clamp":
        delta = torch.clamp(torch.clamp(iz_low, -NGUARD, Nz) - col,
                            delta_lo, delta_hi)
    else:
        delta = torch.remainder(iz_low - col - delta_lo, Nz) + delta_lo
    # Corner j of the 4-point footprint lands at offset delta + j
    zw = [sum(sz[j] * (delta == o - j) for j in range(4))
          for o in range(delta_lo, delta_hi + 4)]
    bn_idx = torch.clamp(torch.ceil(r_cell).long(), 0, Nr)
    sr_m0, sr_mh = cubic_radial_rows(sr_plain, u, bn_idx, ruyten_cubic)
    return dict(cos=cos, sin=sin, below=[(ir_low + j) < 0 for j in range(4)],
                zw=zw, sr_m0=sr_m0, sr_mh=sr_mh,
                ir_buf=torch.clamp(ir_low + NGUARD, max=Nr),
                ir_low=ir_low, u=u, bn_idx=bn_idx, s_sub=uz_, delta=delta,
                ok=ok)


def _corner_weights_cubic(geom, meta, sr_m0=None, sr_mh=None):
    """Per-corner (Nz, K, C) radial weights with the mode-row select and
    the below-axis channel flips."""
    sr_m0 = geom["sr_m0"] if sr_m0 is None else sr_m0
    sr_mh = geom["sr_mh"] if sr_mh is None else sr_mh
    out = []
    for j in range(4):
        sr = torch.where(meta["is_mode0"][None, None, :],
                         sr_m0[j][:, :, None], sr_mh[j][:, :, None])
        out.append(torch.where(geom["below"][j][:, :, None],
                               meta["flip"][None, None, :] * sr, sr))
    return out


def _build_V_cubic(geom, channel_vals, meta):
    """Channel blocks [(Nz, K, C)] * (n_off*4) of one cubic deposit."""
    srj = _corner_weights_cubic(geom, meta)
    blocks = []
    for zw in geom["zw"]:
        zwv = channel_vals * zw[:, :, None]
        for j in range(4):
            blocks.append(zwv * srj[j])
    return blocks


def _reassemble_cubic(out, Nz, Nr, zfold, delta_lo, delta_hi, C):
    """Shifted adds of the (Nz, Nrb, n_off*4*C) cubic contraction output
    into the folded (Nz, Nr, C) grid."""
    Nzb, Nrb = Nz + 2 * NGUARD, Nr + 2 * NGUARD
    n_off = delta_hi + 4 - delta_lo
    out = out.reshape(Nz, Nrb, n_off, 4, C)
    buf = torch.zeros((Nzb, Nrb, C), dtype=out.dtype, device=out.device)
    for i, o in enumerate(range(delta_lo, delta_hi + 4)):
        plane = out[:, :, i, 0, :].clone()
        for j in range(1, 4):
            plane[:, j:, :] += out[:, :-j, i, j, :]
        _add_shifted_plane(buf, plane, o + NGUARD, Nz, Nzb, zfold)
    return _fold_guard_cells(buf, Nz, Nr, zfold)


def _dense_deposit_cubic(geom, channel_vals, meta, Nz, Nr, zfold,
                         delta_lo, delta_hi):
    """Contract padded cubic channels by radial row (``_contract``)."""
    out = _contract(geom["ir_buf"], _build_V_cubic(geom, channel_vals, meta),
                    Nr + 2 * NGUARD)
    return _reassemble_cubic(out, Nz, Nr, zfold, delta_lo, delta_hi,
                             channel_vals.shape[2])


def deposit_rho_J_sorted_cubic(sort, x, y, z, w, q, ux, uy, uz, inv_gamma,
                               dt_half, Nm, invdz, zmin, Nz, invdr, rmin,
                               Nr, ruyten_cubic, zfold="periodic",
                               comp=None, with_drho=False, with_rho=True,
                               vz_shift=0.0):
    """Cubic counterpart of deposit_rho_J_sorted (the sort built at the
    J positions): J at the current positions, rho at the positions one
    half push later, and optionally the telescoped d(rho), contracted by
    ``_contract``.  vz_shift: the Galilean grid speed, as in
    deposit_rho_J_sorted.  Returns (Jr, Jt, Jz, rho[, drho]) raw grids;
    rho is None when not ``with_rho``."""
    x, y, z, w, ux, uy, uz, inv_gamma, comp = _padded_particles(
        sort, x, y, z, w, ux, uy, uz, inv_gamma, comp)

    # --- J at the current (n+1/2) positions: base offsets {-2, -1}
    geom = _padded_geometry_cubic(sort, x, y, z, invdz, zmin, Nz, invdr,
                                  rmin, Nr, ruyten_cubic, zfold,
                                  delta_lo=-2, delta_hi=-1, comp=comp)
    cos, sin = geom["cos"], geom["sin"]
    cos_m, sin_m = _mode_phases(cos, sin, Nm)
    wj = q * w
    js = current_components(wj, cos, sin, ux, uy, uz, inv_gamma)
    channels = _pack_padded([_modes(j0, cos_m, sin_m) for j0 in js], Nm)
    meta = _channel_meta(Nm, 3, [-1.0, -1.0, +1.0], x.dtype, x.device)
    if not with_drho:
        out = _dense_deposit_cubic(geom, channels, meta, Nz, Nr, zfold,
                                   delta_lo=-2, delta_hi=-1)
        Jr, Jt, Jz = _unpack_channels(out, 3, Nm)

    # --- rho at the half-pushed (n+1) positions (base offsets -3..-1)
    chdt = c * dt_half
    rho = None
    meta1 = _channel_meta(Nm, 1, [+1.0], x.dtype, x.device)
    if with_rho:
        x2 = x + chdt * inv_gamma * ux
        y2 = y + chdt * inv_gamma * uy
        z2 = z + chdt * inv_gamma * uz - vz_shift * dt_half
        geom2 = _padded_geometry_cubic(sort, x2, y2, z2, invdz, zmin, Nz,
                                       invdr, rmin, Nr, ruyten_cubic, zfold,
                                       delta_lo=-3, delta_hi=-1, comp=comp)
        cos_m2, sin_m2 = _mode_phases(geom2["cos"], geom2["sin"], Nm)
        channels2 = _pack_padded([_modes(wj, cos_m2, sin_m2)], Nm)
        out2 = _dense_deposit_cubic(geom2, channels2, meta1, Nz, Nr, zfold,
                                    delta_lo=-3, delta_hi=-1)
        rho = _unpack_channels(out2, 1, Nm)[0]
    if not with_drho:
        return Jr, Jt, Jz, rho

    # --- drho via per-particle telescoped differences (see
    # deposit_rho_J_sorted): endpoint cubic shapes from the mid geometry
    # plus half-step deltas in cell units; z crossers are split to the
    # right offset block (exact in z), radial crossers keep the mid bin
    # frame, as in fbpic_tpu
    hz = (chdt * inv_gamma * uz - vz_shift * dt_half) * invdz
    vr = geom["cos"] * ux + geom["sin"] * uy
    hr = chdt * inv_gamma * vr * invdr
    s_mid, delta_mid, ok = geom["s_sub"], geom["delta"], geom["ok"]

    def z_blocks(s_shift):
        """Offset-block cubic z weights (offsets -3..3) at sub-cell
        s_mid + s_shift, split so crossers land in the right block."""
        sp_ = s_mid + s_shift
        shift = torch.ceil(sp_).long() - 1               # u' in (0, 1]
        sj = tuple(s_ * ok for s_ in cubic_shape(sp_ - shift.to(sp_.dtype)))
        d = delta_mid + shift
        return [sum(sj[j] * (d == o - j) for j in range(4))
                for o in range(-3, 4)]

    zw_a = z_blocks(-hz)
    zw_b = z_blocks(hz)

    def radial_rows(u_):
        return cubic_radial_rows(cubic_shape(u_), u_, geom["bn_idx"],
                                 ruyten_cubic)

    m0_a, mh_a = radial_rows(geom["u"] - hr)
    m0_b, mh_b = radial_rows(geom["u"] + hr)
    sr_a = _corner_weights_cubic(geom, meta1, sr_m0=m0_a, sr_mh=mh_a)
    sr_b = _corner_weights_cubic(geom, meta1, sr_m0=m0_b, sr_mh=mh_b)

    # Endpoint phases (differences are small relative to O(1) inputs)
    x0e, y0e = x - chdt * inv_gamma * ux, y - chdt * inv_gamma * uy
    x2e, y2e = x + chdt * inv_gamma * ux, y + chdt * inv_gamma * uy
    r0e = torch.clamp(torch.sqrt(x0e * x0e + y0e * y0e), min=1e-30)
    r2e = torch.clamp(torch.sqrt(x2e * x2e + y2e * y2e), min=1e-30)
    cma, sma = _mode_phases(x0e / r0e, y0e / r0e, Nm)
    cmb, smb = _mode_phases(x2e / r2e, y2e / r2e, Nm)
    one = torch.ones_like(w)
    ph_a = _pack_padded([_modes(one, cma, sma)], Nm)
    ph_b = _pack_padded([_modes(one, cmb, smb)], Nm)
    dph = ph_b - ph_a
    wj3 = wj[:, :, None]

    # Telescoped difference blocks: 7 z offsets x 4 radial corners
    V_D = []
    for o in range(7):
        za = zw_a[o][:, :, None]
        zb = zw_b[o][:, :, None]
        dz_ = zb - za
        for j in range(4):
            dsr = sr_b[j] - sr_a[j]
            V_D.append(wj3 * (dph * (za * sr_a[j]) + ph_b * (dz_ * sr_a[j])
                              + ph_b * (zb * dsr)))

    # ONE contraction for J + drho (they share the mid-position rows)
    V_J = _build_V_cubic(geom, channels, meta)
    W_J = sum(b.shape[2] for b in V_J)
    out_all = _contract(geom["ir_buf"], V_J + V_D, Nr + 2 * NGUARD)
    out_J = _reassemble_cubic(out_all[..., :W_J], Nz, Nr, zfold, -2, -1,
                              channels.shape[2])
    Jr, Jt, Jz = _unpack_channels(out_J, 3, Nm)
    # drho z blocks span offsets [-3, 3] = base range [-3, 0] + corners
    out_D = _reassemble_cubic(out_all[..., W_J:], Nz, Nr, zfold, -3, 0,
                              ph_a.shape[2])
    drho = _unpack_channels(out_D, 1, Nm)[0]
    return Jr, Jt, Jz, rho, drho

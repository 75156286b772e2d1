"""Field gathering on the sorted (Nz, K) layout: grid -> per-particle E, B.

Behavioral reference:
FBPIC's fbpic/particles/gathering/threading_methods.py:26-208 and
gathering/inline_functions.py (axis guard-cell handling, mode factors).
"""
import torch

from .cuda_gather import gather_sorted


def _cylindrical_projection(x, y):
    r = torch.sqrt(x**2 + y**2)
    nz = r != 0.0
    invr = torch.where(nz, 1.0 / torch.where(nz, r, torch.ones_like(r)),
                       torch.zeros_like(r))
    cos = torch.where(nz, x * invr, torch.ones_like(x))
    sin = torch.where(nz, y * invr, torch.zeros_like(y))
    return r, cos, sin


def _stack_interp_channels(interp, Nm):
    """Stack interp E/B into (Nz, Nr, C) with C = 6 * Nm * 2 channels.

    Channel layout: comp-major (Er,Et,Ez,Br,Bt,Bz), then mode, then re/im.
    """
    cols = []
    for comp in (interp.Er, interp.Et, interp.Ez,
                 interp.Br, interp.Bt, interp.Bz):
        for m in range(Nm):
            cols.append(comp[m].real)
            cols.append(comp[m].imag)
    return torch.stack(cols, dim=-1)


def _guard_signs(Nm, dtype, device):
    """Per-channel sign of the axis guard row: transverse components
    flip by -(-1)^m, z components by (-1)^m (inline_functions.py)."""
    signs = []
    for comp_i in range(6):
        for m in range(Nm):
            msign = 1.0 if m % 2 == 0 else -1.0
            s = msign if comp_i in (2, 5) else -msign
            signs += [s, s]
    return torch.tensor(signs, dtype=dtype, device=device)


def gather_fields_sorted(
    xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz,
    invdr, rmin, Nr, comp=None, zfold="periodic",
):
    """Linear-shape gather on the column-padded (Nz, K) layout.

    The sort columns must lie within one cell of the particle positions
    (exact at sort time; the banded re-sort keeps the plan exact).  The
    4-corner fetch, mode sum and rotation run in K2
    (``cuda_gather.gather_sorted``).

    Returns (Ex, Ey, Ez, Bx, By, Bz) as (Nz, K) tensors (invalid slots
    zero).
    """
    return gather_sorted(**gather_operands(
        xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz, invdr,
        rmin, Nr, comp=comp, zfold=zfold))


def gather_operands(xp, yp, zp, valid, interp, rmax_gather, invdz, zmin,
                    Nz, invdr, rmin, Nr, comp=None, zfold="periodic"):
    """The keyword arguments of K2 (``gather_sorted``): per-slot corner
    indices and weights, and the field channels with the signed axis
    guard row."""
    Nm = interp.Er.shape[0]
    rdt = xp.dtype
    r, cos, sin = _cylindrical_projection(xp, yp)
    r_cell = invdr * (r - rmin) - 0.5
    z_cell = invdz * (zp - zmin) - 0.5

    ir_lower = torch.floor(r_cell).long()
    iz_lower = torch.floor(z_cell).long()
    Sr_upper = r_cell - ir_lower.to(rdt)
    Sz_upper = z_cell - iz_lower.to(rdt)
    if comp is not None:
        cx, cy, cz = comp
        Sz_upper = Sz_upper + invdz * cz
        Sr_upper = Sr_upper + invdr * (
            (xp * cx + yp * cy) / torch.clamp(r, min=1e-30))
    ok = valid.to(rdt) * (r < rmax_gather).to(rdt)

    # Radial extended axis: row 0 = signed axis guard (ir = -1), rows
    # 1..Nr = ir 0..Nr-1
    l_r = torch.clamp(ir_lower + 1, 0, Nr)

    # z offset of the footprint base from the sort column (periodic z:
    # centered residue, so seam crossers keep a small offset)
    D = 1
    col = torch.arange(Nz, device=xp.device)[:, None]
    delta = iz_lower - col
    if zfold == "periodic":
        delta = torch.remainder(delta + Nz // 2, Nz) - Nz // 2
    o_lo = torch.clamp(delta, -D, D) + D

    F = _stack_interp_channels(interp, Nm)          # (Nz, Nr, C)
    guard = _guard_signs(Nm, rdt, xp.device)
    Fg = torch.cat([guard[None, None, :] * F[:, :1], F], dim=1).contiguous()
    return dict(o_lo=o_lo, l_r=l_r, sr_upper=Sr_upper.contiguous(),
                sz_upper=Sz_upper.contiguous(), ok=ok.contiguous(),
                cos=cos.contiguous(), sin=sin.contiguous(), Fg=Fg,
                n_off=2 * D + 1, Nm=Nm)

"""Field gathering: grid -> per-particle E, B.

``gather_fields_sorted`` works on the sorted (Nz, K) layout of resident
species (K2); ``gather_fields_linear`` and ``gather_fields_cubic`` on
particles in any storage order (the non-resident species: plain
PyTorch, as fbpic_tpu computes them with XLA ops, not a Pallas kernel).

Behavioral reference:
FBPIC's fbpic/particles/gathering/threading_methods.py:26-208 and
gathering/inline_functions.py (axis guard-cell handling, mode factors).
"""
import functools

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


@functools.lru_cache(maxsize=None)
def _linear_gather_signs(Nm, dtype, device):
    """(-1)^m per (mode, re/im) and the guard sign of each component
    (-1 transverse, +1 z) of gather_fields_linear, built once per
    (Nm, dtype, device): a tensor made from a host list is a blocking
    copy on a CUDA device."""
    msign = torch.tensor([(-1.0) ** m for m in range(Nm)], dtype=dtype,
                         device=device).repeat_interleave(2)
    zsign = torch.tensor([-1.0, -1.0, 1.0, -1.0, -1.0, 1.0], dtype=dtype,
                         device=device)
    return msign, zsign


def gather_fields_linear(x, y, z, interp, rmax_gather, invdz, zmin, Nz,
                         invdr, rmin, Nr, comp=None):
    """Gather E and B at particles in any storage order (linear shapes).

    The 2x2 footprint of the fields is packed into one table -- the
    grid and its copies shifted by one radial row and one z row (z
    taken mod Nz, open z too, as in fbpic_tpu and K2) -- and fetched
    with one index per particle: (component, corner x mode x re/im).
    Broadcast products then apply the corner weights and the mode sum
    Re(F_m e^{-i m theta}) (weights 1 for m = 0, 2 above) at once.
    Below the axis the lower radial weight moves to the guard cell,
    which reads radial row 0 with the sign -(-1)^m (transverse) or
    (-1)^m (z): a second weighted sum over the two corners of row 0.
    The Kahan words, when given, are folded into the sub-cell offsets.
    Particles at r >= rmax_gather gather zero.

    Returns (Ex, Ey, Ez, Bx, By, Bz), each shaped like x.
    """
    Nm = interp.Er.shape[0]
    rdt, dev = x.dtype, x.device
    r, cos, sin = _cylindrical_projection(x, y)
    r_cell = invdr * (r - rmin) - 0.5
    z_cell = invdz * (z - zmin) - 0.5
    ir_lower = torch.floor(r_cell).long()
    iz_lower = torch.floor(z_cell).long()
    Sr_upper = r_cell - ir_lower.to(rdt)
    Sz_upper = z_cell - iz_lower.to(rdt)
    if comp is not None:
        cx, cy, cz = comp
        Sz_upper = Sz_upper + invdz * cz
        Sr_upper = Sr_upper + invdr * (
            (x * cx + y * cy) / torch.clamp(r, min=1e-30))
    Sr_lower = 1.0 - Sr_upper
    Sz_lower = 1.0 - Sz_upper

    # (Nz, Nr, component, corner, mode x re/im); corners (iz, ir),
    # (iz, ir+1), (iz+1, ir), (iz+1, ir+1)
    F = _stack_interp_channels(interp, Nm).reshape(Nz, Nr, 6, 2 * Nm)
    Fr1 = torch.cat([F[:, 1:], F[:, -1:]], dim=1)
    table = torch.stack([F, Fr1, torch.roll(F, -1, 0),
                         torch.roll(Fr1, -1, 0)], dim=3)
    row = (torch.remainder(iz_lower, Nz) * Nr
           + torch.clamp(ir_lower, 0, Nr - 1))
    T = table.reshape(Nz * Nr, 6, 4, 2 * Nm).index_select(0, row)

    # Mode-sum weights (cos m th, -sin m th) x (1, 2, 2, ...)
    pr, pi = torch.ones_like(cos), torch.zeros_like(sin)
    W = [pr, -pi]
    for _ in range(1, Nm):
        pr, pi = pr * cos + pi * sin, pi * cos - pr * sin
        W += [2.0 * pr, -2.0 * pi]
    W = torch.stack(W, dim=-1)                                # (Np, 2 Nm)
    below = ir_lower < 0
    zero = torch.zeros((), dtype=rdt, device=dev)
    w0 = torch.where(below, Sr_upper, Sr_lower)
    w1 = torch.where(below, zero, Sr_upper)
    guard = torch.where(below, Sr_lower, zero)
    corner = torch.stack([Sz_lower * w0, Sz_lower * w1, Sz_upper * w0,
                          Sz_upper * w1], dim=-1)             # (Np, 4)
    corner_g = torch.stack([Sz_lower * guard, Sz_upper * guard], dim=-1)
    msign, zsign = _linear_gather_signs(Nm, rdt, dev)
    # Weighted sums over (corner, mode x re/im) as broadcast products:
    # a batched matmul of this shape (a 6 x 8 Nm block a particle) is
    # many times slower on the card
    V = (corner[:, :, None] * W[:, None, :])[:, None]        # (Np, 1, 4, 2Nm)
    out = (T * V).sum(dim=(2, 3))
    Vg = (corner_g[:, :, None] * (W * msign)[:, None, :])[:, None]
    out = out + zsign * (T[:, :, ::2] * Vg).sum(dim=(2, 3))
    out = out * (r < rmax_gather).to(rdt)[:, None]
    Fr_E, Ft_E, Fz_E, Fr_B, Ft_B, Fz_B = out.unbind(1)
    return (cos * Fr_E - sin * Ft_E, sin * Fr_E + cos * Ft_E, Fz_E,
            cos * Fr_B - sin * Ft_B, sin * Fr_B + cos * Ft_B, Fz_B)


#: _guard_signs built once per (Nm, dtype, device): the sign of a radial
#: row below the axis in the cubic gather (a tensor made from a host
#: list is a blocking copy on a CUDA device)
_cubic_flip_channels = functools.lru_cache(maxsize=None)(_guard_signs)


def gather_fields_cubic(x, y, z, interp, rmax_gather, invdz, zmin, Nz,
                        invdr, rmin, Nr, comp=None):
    """Gather E and B at particles in any storage order (cubic shapes).

    The 4x4 stencil: 16 fetches of the (component, mode, re/im) channels
    by index, each weighted by its radial and z cubic weights; a radial
    index below the axis reads row -ir - 1 with the sign (-1)^m (z) or
    -(-1)^m (transverse); rows past the edge clamp to Nr - 1, z wraps
    mod Nz (reference: gathering/threading_methods.py:208+,
    gathering/inline_functions.py:93-187).  Then the mode sum
    Re(F_m e^{-i m theta}) (weights 1 for m = 0, 2 above) and the
    rotation to Cartesian.  The Kahan words, when given, are folded into
    the sub-cell offsets.  Particles at r >= rmax_gather gather zero.

    Returns (Ex, Ey, Ez, Bx, By, Bz), each shaped like x.
    """
    Nm = interp.Er.shape[0]
    rdt = x.dtype
    r, cos, sin = _cylindrical_projection(x, y)
    r_cell = invdr * (r - rmin) - 0.5
    z_cell = invdz * (z - zmin) - 0.5

    ir_lowest = torch.floor(r_cell).long() - 1
    r_local = r_cell - ir_lowest.to(rdt)
    iz_lowest = torch.floor(z_cell).long() - 1
    z_local = z_cell - iz_lowest.to(rdt)
    if comp is not None:
        cx, cy, cz = comp
        r_local = r_local + invdr * (
            (x * cx + y * cy) / torch.clamp(r, min=1e-30))
        z_local = z_local + invdz * cz
    Sr = _gather_cubic_weights(r_local)
    Sz = _gather_cubic_weights(z_local)

    Fflat = _stack_interp_channels(interp, Nm).reshape(Nz * Nr, -1)
    flip = _cubic_flip_channels(Nm, rdt, x.device)
    one = torch.ones((), dtype=rdt, device=x.device)
    Fm = torch.zeros((x.shape[0], Fflat.shape[1]), dtype=rdt,
                     device=x.device)
    for jr in range(4):
        ir = ir_lowest + jr
        below = ir < 0
        ir_eff = torch.clamp(torch.where(below, -ir - 1, ir), max=Nr - 1)
        sign = torch.where(below[:, None], flip[None, :], one)
        for jz in range(4):
            iz = torch.remainder(iz_lowest + jz, Nz)
            vals = Fflat.index_select(0, iz * Nr + ir_eff)
            Fm = Fm + (Sr[jr] * Sz[jz])[:, None] * sign * vals

    # Mode sum with e^{-i m theta}, weights (1, 2, 2, ...)
    pr, pi = torch.ones_like(cos), torch.zeros_like(sin)
    W = [pr, -pi]
    for _ in range(1, Nm):
        pr, pi = pr * cos + pi * sin, pi * cos - pr * sin
        W += [2.0 * pr, -2.0 * pi]
    W = torch.stack(W, dim=-1).reshape(-1, 1, 2 * Nm)
    out = (Fm.reshape(-1, 6, 2 * Nm) * W).sum(dim=2)
    out = out * (r < rmax_gather).to(rdt)[:, None]
    Fr_E, Ft_E, Fz_E, Fr_B, Ft_B, Fz_B = out.unbind(1)
    return (cos * Fr_E - sin * Ft_E, sin * Fr_E + cos * Ft_E, Fz_E,
            cos * Fr_B - sin * Ft_B, sin * Fr_B + cos * Ft_B, Fz_B)


def _gather_cubic_weights(s):
    """Cubic weights of the 4 points at s - 2, s - 1, 2 - s, 1 - s from
    the lowest one (the gather's form of the B-spline)."""
    return (-1. / 6. * (s - 2.) ** 3,
            1. / 6. * (3. * (s - 1.) ** 3 - 6. * (s - 1.) ** 2 + 4.),
            1. / 6. * (3. * (2. - s) ** 3 - 6. * (2. - s) ** 2 + 4.),
            -1. / 6. * (1. - s) ** 3)


def gather_fields_sorted(
    xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz,
    invdr, rmin, Nr, comp=None, zfold="periodic",
):
    """Linear-shape gather on the column-padded (Nz, K) layout.

    The sort columns must lie within one cell of the particle positions
    (exact at sort time; the banded re-sort keeps the plan exact).  The
    whole gather -- geometry, 4-corner fetch, mode sum and rotation --
    is K2 (``cuda_gather.gather_sorted``): one kernel launch on CUDA
    tensors, its plain version (``gather_operands`` and the one-hot
    contraction) on CPU tensors.

    Returns (Ex, Ey, Ez, Bx, By, Bz) as (Nz, K) tensors (invalid slots
    zero).
    """
    return gather_sorted(xp, yp, zp, valid, interp, rmax_gather, invdz, zmin,
                         Nz, invdr, rmin, Nr, comp=comp, zfold=zfold)


def gather_operands(xp, yp, zp, valid, interp, rmax_gather, invdz, zmin,
                    Nz, invdr, rmin, Nr, comp=None, zfold="periodic"):
    """The operands of K2's plain corner fetch
    (``cuda_gather.gather_corners_plain``): per-slot corner indices and
    weights, and the field channels with the signed axis guard row --
    what the kernel computes in registers and shared memory."""
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

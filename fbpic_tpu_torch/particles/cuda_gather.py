"""K2: the sorted-layout field gather, as a CUDA kernel.

Replaces the Pallas TPU kernel
``fbpic_tpu/particles/pallas_gather.py::_gather_call`` (reached through
``gather_sorted_pallas`` from ``gather.gather_fields_sorted``).  It
computes what fbpic_tpu's ``gather_fields_sorted`` computes (drift 0):
per particle slot of the column-padded (Nz, K) layout, the bilinear
4-corner window of all field channels (the E/B modes with the signed
axis-guard row below radial row 0), weighted by Sz * Sr * ok, summed
over the azimuthal modes as Re(F_m e^{-i m theta}) (weights 1 and 2)
and rotated to (Ex, Ey, Ez, Bx, By, Bz); invalid slots give zeros.

The kernel (``csrc/gather.cu``) takes the particles and the fields as
they lie and does everything else itself: the padded ``x, y, z`` (Nz,
K), the bool ``valid``, optionally the Kahan words, and the six interp
tensors, complex (Nm, Nz, Nr) with r or z fastest (``torch.fft`` along
z leaves the second), through a table of pointers.  The geometry (the
cylindrical projection, the cells and weights, the z offset and its
periodic fold) is computed in registers, a block stages the z rows of
its columns in shared memory, and a dead slot reads only its flag.  The
wrapper copies, casts and permutes nothing and raises on an operand
that is not of the kernel's type, shape and layout: a call is one
launch.  See the source for what bounds it.

``gather_sorted`` has the signature of ``gather.gather_fields_sorted``.
On CPU tensors it runs the plain PyTorch version (``gather_sorted_plain``:
``gather.gather_operands`` builds the per-slot corner indices, weights
and the stacked guarded field table, then ``gather_corners_plain``
contracts them as fbpic_tpu's XLA path does); on CUDA tensors it
launches the kernel or raises.
"""
import torch

from ..utils import kernels

#: Largest run of z columns one block owns (csrc/gather.cu's BZ_MAX)
BZ_MAX = 2
FIELD_NAMES = ("Er", "Et", "Ez", "Br", "Bt", "Bz")


def gather_corners_plain(o_lo, l_r, sr_upper, sz_upper, ok, cos, sin, Fg,
                         n_off, Nm):
    """The corner fetch, mode sum and rotation on the operands of
    ``gather.gather_operands``: one-hot corner weights contracted
    against the z-rolled copies of the guarded field table Fg (Nz, Nr+1,
    12 Nm), as fbpic_tpu's XLA path (and its Pallas kernel) does."""
    Nrx = Fg.shape[1]
    Nr = Nrx - 1
    J = n_off * Nrx
    D = (n_off - 1) // 2
    sr_lower = 1.0 - sr_upper
    sz_lower = 1.0 - sz_upper

    # One-hot corner weights S[b, k, j], j = (z offset, radial row),
    # accumulated corner by corner
    o_hi = torch.clamp(o_lo + 1, max=n_off - 1)
    u_r = torch.clamp(l_r + 1, max=Nr)
    S = torch.zeros((*o_lo.shape, J), dtype=Fg.dtype, device=Fg.device)
    for o_idx, ridx, wgt in ((o_lo, l_r, sz_lower * sr_lower * ok),
                             (o_lo, u_r, sz_lower * sr_upper * ok),
                             (o_hi, l_r, sz_upper * sr_lower * ok),
                             (o_hi, u_r, sz_upper * sr_upper * ok)):
        S.scatter_add_(2, (o_idx * Nrx + ridx)[:, :, None].long(),
                       wgt[:, :, None])
    F_ext = torch.cat([torch.roll(Fg, -o, dims=0) for o in range(-D, D + 1)],
                      dim=1)                              # (Nz, J, C)
    Fm = torch.einsum("bkj,bjc->bkc", S, F_ext)           # (Nz, K, C)

    # Mode sum Re(F_m e^{-i m theta}), weight 1 (m = 0) / 2 (m > 0)
    pr, pi = torch.ones_like(cos), torch.zeros_like(sin)
    pr_list, pi_list = [pr], [pi]
    for _ in range(1, Nm):
        pr, pi = pr * cos + pi * sin, pi * cos - pr * sin
        pr_list.append(pr)
        pi_list.append(pi)
    mode_w = torch.tensor([1.0] + [2.0] * (Nm - 1), dtype=cos.dtype,
                          device=cos.device)
    W = torch.stack([torch.stack(pr_list, dim=-1) * mode_w,
                     -torch.stack(pi_list, dim=-1) * mode_w], dim=-1)
    Fm4 = Fm.reshape(*Fm.shape[:2], 6, Nm, 2)
    out = torch.einsum("bkcmt,bkmt->bkc", Fm4, W)         # (Nz, K, 6)

    Fr_E, Ft_E, Fz_E, Fr_B, Ft_B, Fz_B = out.unbind(-1)
    return (cos * Fr_E - sin * Ft_E, sin * Fr_E + cos * Ft_E, Fz_E,
            cos * Fr_B - sin * Ft_B, sin * Fr_B + cos * Ft_B, Fz_B)


def gather_sorted_plain(xp, yp, zp, valid, interp, rmax_gather, invdz, zmin,
                        Nz, invdr, rmin, Nr, comp=None, zfold="periodic"):
    """Plain PyTorch version of K2 (same signature and result)."""
    from .gather import gather_operands
    return gather_corners_plain(**gather_operands(
        xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz, invdr,
        rmin, Nr, comp=comp, zfold=zfold))


def gather_smem_bytes(esize, Nm, Nr, bz):
    """Dynamic shared memory of a block that owns `bz` columns: bz + 2
    staged z rows of Nr + 1 entries (the guard row first), each entry
    the 12 Nm words of a corner and one pad (re, im) pair, an odd number
    of pairs (as csrc/gather.cu reckons it); 0 for bz = 0 (no
    staging)."""
    return 0 if bz == 0 else (bz + 2) * (Nr + 1) * (12 * Nm + 2) * esize


def pick_bz(esize, Nm, Nr, limit=kernels.SMEM_PER_BLOCK - kernels.SMEM_STATIC):
    """The largest run of columns (up to BZ_MAX) whose staged rows fit a
    block's shared memory; 0 when not even one column's do (the kernel
    then reads the corners from the fields directly)."""
    for bz in range(BZ_MAX, 0, -1):
        if gather_smem_bytes(esize, Nm, Nr, bz) <= limit:
            return bz
    return 0


def field_strides(what, fields, shape, dtype, device):
    """(z stride, r stride) in complex elements of the six interp
    tensors, which must share them: (Nm, Nz, Nr) of `dtype` on `device`,
    dense with r fastest (contiguous) or z fastest (the layout torch.fft
    along z leaves).  Raises on anything else."""
    Nm, Nz, Nr = shape
    strides = None
    for name, t in zip(FIELD_NAMES, fields):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, not {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"not {tuple(shape)}")
        if t.is_conj() or t.is_neg():
            raise ValueError(f"{what}: {name} is a lazy conjugate/negation")
        st_m, st_z, st_r = t.stride()
        if t.is_contiguous():
            s = (Nr, 1)
        elif ((st_z == 1 or Nz == 1) and (st_r == Nz or Nr == 1)
              and (st_m == Nz * Nr or Nm == 1)):
            s = (1, Nz)
        else:
            raise ValueError(f"{what}: {name} is not contiguous (neither r "
                             f"nor z fastest)")
        if strides not in (None, s):
            raise ValueError(f"{what}: the interp fields differ in layout")
        strides = s
    return strides


def check_gather_operands(what, xp, yp, zp, valid, interp, Nz, Nr,
                          comp=None, zfold="periodic"):
    """Raise unless the operands are what K2 reads in place: positions
    and Kahan words (Nz, K) contiguous float32 / float64 of one dtype,
    `valid` (Nz, K) contiguous bool, the interp fields as
    ``field_strides`` takes them, all on one device.  Returns (the six
    fields, Nm, z stride, r stride)."""
    dev = xp.device
    dtype = xp.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    if zfold not in ("periodic", "clamp"):
        raise ValueError(f"{what}: unknown zfold {zfold!r}")
    if xp.dim() != 2 or xp.shape[0] != Nz:
        raise ValueError(f"{what}: positions are not (Nz, K)")
    slot = tuple(xp.shape)
    parts = [("x", xp, dtype), ("y", yp, dtype), ("z", zp, dtype),
             ("valid", valid, torch.bool)]
    if comp is not None:
        parts += [(n, t, dtype) for n, t in zip(("cx", "cy", "cz"), comp)]
    for name, t, dt in parts:
        kernels.check_operand(what, name, t, dev, dt, slot)
    fields = [getattr(interp, n) for n in FIELD_NAMES]
    Nm = fields[0].shape[0]
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    return (fields, Nm) + field_strides(what, fields, (Nm, Nz, Nr), cdt, dev)


def gather_sorted(xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz,
                  invdr, rmin, Nr, comp=None, zfold="periodic"):
    """K2.  xp, yp, zp (Nz, K) padded positions, valid (Nz, K) bool,
    interp the six complex (Nm, Nz, Nr) E/B fields, comp the Kahan words
    (cx, cy, cz) or None.  Returns (Ex, Ey, Ez, Bx, By, Bz), (Nz, K)
    each, zero on invalid slots and at r >= rmax_gather."""
    if xp.device.type == "cpu":
        return gather_sorted_plain(xp, yp, zp, valid, interp, rmax_gather,
                                   invdz, zmin, Nz, invdr, rmin, Nr,
                                   comp=comp, zfold=zfold)
    what = "sorted gather"
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    fields, Nm, sz, sr = check_gather_operands(
        what, xp, yp, zp, valid, interp, Nz, Nr, comp=comp, zfold=zfold)
    dtype, slot = xp.dtype, tuple(xp.shape)

    out = torch.empty((6, *slot), dtype=dtype, device=dev)
    if out.numel() == 0:
        return tuple(out.unbind(0))
    lib = kernels.library("gather")
    fn = lib.gather_sorted_f32 if dtype == torch.float32 \
        else lib.gather_sorted_f64
    comps = list(comp) if comp is not None else [None] * 3
    table = kernels.pointer_table([xp, yp, zp, valid] + comps + fields
                                  + [out])
    bz = pick_bz(xp.element_size(), Nm, Nr)
    code = fn(table, float(invdz), float(zmin), float(invdr), float(rmin),
              float(rmax_gather), Nz, slot[1], Nr, Nm, sz, sr,
              int(zfold == "periodic"), bz,
              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(code, what)
    gather_sorted.launches += 1
    return tuple(out.unbind(0))


#: Kernel launches (CUDA path only), read by the chip smoke run.
gather_sorted.launches = 0

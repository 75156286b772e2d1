"""K2: the sorted-layout field gather, as a CUDA kernel.

Replaces the Pallas TPU kernel
``fbpic_tpu/particles/pallas_gather.py::_gather_call`` (reached through
``gather_sorted_pallas`` from ``gather.gather_fields_sorted``).  Per
particle slot it fetches the bilinear 4-corner window of all field
channels from ``Fg`` (Nz, Nr+1, C) -- the E/B channels with the signed
axis-guard row prepended -- weights it by Sz * Sr * ok, sums the
azimuthal modes as Re(F_m e^{-i m theta}) (weights 1 and 2) and rotates
to (Ex, Ey, Ez, Bx, By, Bz).  The kernel (``csrc/gather.cu``) reads Fg
directly, one thread per particle; the TPU's corner-baked F4 / one-hot
MXU fetch is not carried over.  See the source for what bounds it.

``gather_sorted`` runs the plain PyTorch version (the one-hot einsum of
fbpic_tpu's XLA path) for CPU tensors, and launches the kernel or raises
for CUDA tensors.
"""
import torch

from ..utils.kernels import library, check_launch


def gather_sorted_plain(o_lo, l_r, sr_upper, sz_upper, ok, cos, sin, Fg,
                        n_off, Nm):
    """Plain PyTorch version of K2: one-hot corner weights contracted
    against the z-rolled field copies."""
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


def gather_sorted(o_lo, l_r, sr_upper, sz_upper, ok, cos, sin, Fg, n_off,
                  Nm):
    """K2.  o_lo (Nz, K) int: clipped z-offset index in [0, n_off);
    l_r (Nz, K) int: lower radial row of the extended axis, in [0, Nr];
    Fg (Nz, Nr+1, 12*Nm).  Returns (Ex, Ey, Ez, Bx, By, Bz), (Nz, K) each.
    """
    if Fg.device.type == "cpu":
        return gather_sorted_plain(o_lo, l_r, sr_upper, sz_upper, ok, cos,
                                   sin, Fg, n_off, Nm)
    if Fg.device.type != "cuda":
        raise ValueError(f"sorted gather: unsupported device {Fg.device}")
    dtype = Fg.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sorted gather: unsupported dtype {dtype}")
    Nz, K = o_lo.shape
    Nr = Fg.shape[1] - 1
    if tuple(Fg.shape) != (Nz, Nr + 1, 12 * Nm) or not Fg.is_contiguous():
        raise ValueError(f"sorted gather: Fg shape {tuple(Fg.shape)}")
    idx = [t.to(torch.int32).contiguous() for t in (o_lo, l_r)]
    reals = [sr_upper, sz_upper, ok, cos, sin]
    for t in idx + reals:
        if t.device != Fg.device or tuple(t.shape) != (Nz, K):
            raise ValueError("sorted gather: operand device/shape mismatch")
    for t in reals:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError("sorted gather: operands must be contiguous "
                             f"{dtype} tensors")
    out = torch.empty((6, Nz, K), dtype=dtype, device=Fg.device)
    lib = library("gather")
    fn = lib.gather_sorted_f32 if dtype == torch.float32 \
        else lib.gather_sorted_f64
    args = idx + reals + [Fg, out]
    code = fn(*[a.data_ptr() for a in args], Nz, K, Nr, Nm, n_off,
              torch.cuda.current_stream(Fg.device).cuda_stream)
    check_launch(code, "sorted gather")
    gather_sorted.launches += 1
    return tuple(out.unbind(0))


#: Kernel launches (CUDA path only), read by the chip smoke run.
gather_sorted.launches = 0

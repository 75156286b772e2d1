"""K2's plain PyTorch version, frozen from fbpic_tpu_torch's
particles/cuda_gather.py: ``gather_sorted`` runs it on every device
(the CUDA kernel is not part of the reference)."""
import torch

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
    """Plain PyTorch version of K2 (same signature and result; ``zmin``
    a 0-d tensor or a host number)."""
    from .gather import gather_operands
    return gather_corners_plain(**gather_operands(
        xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz, invdr,
        rmin, Nr, comp=comp, zfold=zfold))


def gather_sorted(xp, yp, zp, valid, interp, rmax_gather, invdz, zmin, Nz,
                  invdr, rmin, Nr, comp=None, zfold="periodic"):
    """K2's gather by its plain version, on every device."""
    return gather_sorted_plain(xp, yp, zp, valid, interp, rmax_gather,
                               invdz, zmin, Nz, invdr, rmin, Nr, comp=comp,
                               zfold=zfold)

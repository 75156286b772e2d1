"""K1: the fused J + d(rho) one-hot contraction, as a CUDA kernel.

Replaces the Pallas TPU kernel
``fbpic_tpu/particles/pallas_fused.py::_fused_contract_call`` (reached
through its ``fused_onehot_contract``).  For each z column of the
sorted (Nz, K) layout it computes

    out[col, ir, w] = sum_k [ir_buf(col, k) == ir] * V[col, k, w]

with V = the J blocks of ``sorted_deposit._build_V`` followed by the
d(rho) blocks of ``sorted_deposit._build_V_span_diff``.  The kernel
(``csrc/fused_deposit.cu``) rebuilds V in registers and never writes it
to device memory; the TPU devices (one-hot MXU contraction, 3-term bf16
split, one-hot Ruyten lookup) are not carried over -- it uses plain
FMAs.  See the source for what bounds it on the card.

The kernel reads the operands where they lie: ``channels`` / ``dph`` /
``ph_b`` as the contiguous (Nz, K, C) they are, one contiguous (Nz, K)
tensor per z offset (``geom["zw"]``, ``span["zw_a"]``, ``span["zw_b"]``),
the int64 ``ir_buf`` and ``bn``, the bool ``below_axis`` and
``geom["ok"]``, the mask the z weights were multiplied by.  The wrapper
copies, casts and permutes nothing and raises on an operand that is not
of that type, shape and contiguity: a call is one kernel launch.  A
column costs what its slots up to the last one with ``ok != 0`` cost
(slots with ``ok == 0`` carry zero z weights and contribute exact
zeros), so the kernel is fastest on layouts that keep each column's
live slots first, as ``build_column_sort`` and ``banded_column_resort``
do; any other layout is still summed correctly.

``fused_onehot_contract`` keeps the fbpic_tpu signature and returns
(Nz, Nrb, W).  On CPU tensors it runs the plain PyTorch version
(``fused_onehot_contract_plain``: V materialized, then a segmented sum
by ``index_add_``); on CUDA tensors it launches the kernel or raises.
"""
import torch

from ..utils import kernels
from .deposit import NGUARD, _channel_meta


def fused_blocks(geom, channels, meta, span, dph, ph_b, wj, ruyten, Nm,
                 n_offD):
    """The blocks of K1's V: the J blocks, then the d(rho) blocks."""
    from .sorted_deposit import _build_V, _build_V_span_diff
    metaD = _channel_meta(Nm, 1, [+1.0], channels.dtype, channels.device)
    return (_build_V(geom, channels, meta)
            + _build_V_span_diff(span, dph, ph_b, wj, metaD, ruyten,
                                 n_blocks=n_offD))


def fused_onehot_contract_plain(geom, channels, meta, span, dph, ph_b, wj,
                                ruyten, Nm, Nz, Nr, n_offJ, n_offD):
    """Plain PyTorch version of K1 (same signature and result)."""
    from .sorted_deposit import _contract
    blocks = fused_blocks(geom, channels, meta, span, dph, ph_b, wj, ruyten,
                          Nm, n_offD)
    return _contract(geom["ir_buf"], blocks, Nr + 2 * NGUARD)


def fused_smem_bytes(esize, CJ, nJ, CD, nD, NT, Rt):
    """Dynamic shared memory of one block: the (Rt, W) accumulator, the
    (2, NT) Ruyten table and the ring of staged tiles (as
    csrc/fused_deposit.cu reckons it)."""
    W = nJ * 2 * CJ + nD * 2 * CD
    words = CJ + nJ + 5 + 2 * CD + 2 * nD
    return (kernels.align16(esize * Rt * W) + kernels.align16(esize * 2 * NT)
            + kernels.NSTAGE * kernels.stage_bytes(esize, words, 2))


def fused_operands(geom, channels, meta, span, dph, ph_b, wj, ruyten):
    """(name, tensor, dtype, shape) of every operand of K1, in the order
    of the kernel's pointer table (the output goes between the fixed
    operands and the per-offset z weights)."""
    dtype = channels.dtype
    Nz, K, CJ = channels.shape
    CD = dph.shape[2]
    slot = (Nz, K)
    fixed = [("channels", channels, dtype, (Nz, K, CJ)),
             ("sr0_m0", geom["sr0_m0"], dtype, slot),
             ("sr0_mh", geom["sr0_mh"], dtype, slot),
             ("u_a", span["u_a"], dtype, slot),
             ("u_b", span["u_b"], dtype, slot),
             ("wj", wj, dtype, slot),
             ("dph", dph, dtype, (Nz, K, CD)),
             ("ph_b", ph_b, dtype, (Nz, K, CD)),
             ("below_axis", geom["below_axis"], torch.bool, slot),
             ("ir_buf", geom["ir_buf"], torch.int64, slot),
             ("bn", span["bn"], torch.int64, slot),
             ("ok", geom["ok"], dtype, slot),
             ("ruyten", ruyten, dtype, tuple(ruyten.shape)),
             ("is_mode0", meta["is_mode0"], torch.bool, (CJ,)),
             ("flip", meta["flip"], dtype, (CJ,))]
    zw = [(f"{name}[{o}]", t, dtype, slot)
          for name, ts in (("zw", geom["zw"]), ("zw_a", span["zw_a"]),
                           ("zw_b", span["zw_b"]))
          for o, t in enumerate(ts)]
    return fixed, zw


def fused_onehot_contract(geom, channels, meta, span, dph, ph_b, wj,
                          ruyten, Nm, Nz, Nr, n_offJ, n_offD):
    """K1: (Nz, Nrb, W) with the J blocks in [..., :n_offJ*2*CJ] and
    the d(rho) blocks after them."""
    if channels.device.type == "cpu":
        return fused_onehot_contract_plain(
            geom, channels, meta, span, dph, ph_b, wj, ruyten, Nm, Nz, Nr,
            n_offJ, n_offD)
    dev = channels.device
    if dev.type != "cuda":
        raise ValueError(f"fused deposit: unsupported device {dev}")
    dtype = channels.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused deposit: unsupported dtype {dtype}")
    if channels.dim() != 3 or dph.dim() != 3 or channels.shape[0] != Nz:
        raise ValueError("fused deposit: channels / dph are not (Nz, K, C)")
    K, CJ = channels.shape[1], channels.shape[2]
    CD = dph.shape[2]
    if len(geom["zw"]) != n_offJ or len(span["zw_a"]) != n_offD \
            or len(span["zw_b"]) != n_offD or CJ != 3 * (2 * Nm - 1) \
            or CD != 2 * Nm - 1 or tuple(ruyten.shape) != (2, Nr + 1):
        raise ValueError("fused deposit: inconsistent channel counts")
    if max(n_offJ, n_offD) > kernels.MAX_OFF:
        raise ValueError(f"fused deposit: more than {kernels.MAX_OFF} z "
                         f"offsets in one window")
    # the kernel takes the below-axis flag and the row index once, for the
    # J and the d(rho) blocks alike
    if span["below"].data_ptr() != geom["below_axis"].data_ptr() \
            or span["ir_buf"].data_ptr() != geom["ir_buf"].data_ptr():
        raise ValueError("fused deposit: span and geom do not share their "
                         "below-axis flag and row index")
    fixed, zw = fused_operands(geom, channels, meta, span, dph, ph_b, wj,
                               ruyten)
    for name, t, dt, shape in fixed + zw:
        kernels.check_operand("fused deposit", name, t, dev, dt, shape)
    Nrb = Nr + 2 * NGUARD
    W = n_offJ * 2 * CJ + n_offD * 2 * CD
    out = torch.empty((Nz, Nrb, W), dtype=dtype, device=dev)

    esize = channels.element_size()
    Rt, _ = kernels.pick_row_tiling(
        Nrb, lambda rt: fused_smem_bytes(esize, CJ, n_offJ, CD, n_offD,
                                         Nr + 1, rt))
    lib = kernels.library("fused_deposit")
    fn = (lib.fused_contract_f32 if dtype == torch.float32
          else lib.fused_contract_f64)
    table = kernels.pointer_table([t for _, t, _, _ in fixed] + [out]
                                  + [t for _, t, _, _ in zw])
    code = fn(table, Nz, K, CJ, n_offJ, CD, n_offD, Nrb, Nr + 1, Rt,
              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(code, "fused deposit")
    fused_onehot_contract.launches += 1
    return out


#: Kernel launches (CUDA path only), read by the chip smoke run.
fused_onehot_contract.launches = 0

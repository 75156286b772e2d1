"""K3: the one-hot dense deposit contraction, as a CUDA kernel.

Replaces the Pallas TPU kernel
``fbpic_tpu/particles/pallas_deposit.py::_onehot_deposit_call``, the
kernel behind ``_pallas_dense_deposit``, a drop-in for
``sorted_deposit._dense_deposit``.  For each z column of the sorted
(Nz, K) layout it computes

    out[col, ir, w] = sum_k [ir_buf(col, k) == ir] * V[col, k, w]

with V = the blocks of ``sorted_deposit._build_V`` (channel x per-offset
z weight x radial corner).  The kernel (``csrc/dense_deposit.cu``)
rebuilds V in registers and never writes it to device memory; it works
on the port's packed channels (C = n_comp * (2 Nm - 1)), not the Pallas
kernel's padded re/im layout.

The kernel reads the operands where they lie: ``channel_vals`` as the
contiguous (Nz, K, C) it is, one contiguous (Nz, K) tensor per z offset
(``geom["zw"]``), ``sr0_m0`` / ``sr0_mh``, the int64 ``ir_buf``, the
bool ``below_axis`` and ``geom["ok"]``, the mask the z weights were
multiplied by.  The wrapper copies, casts and permutes nothing and
raises on an operand that is not of that type, shape and contiguity: a
call is one kernel launch.  A column costs what its slots up to the
last one with ``ok != 0`` cost (slots with ``ok == 0`` carry zero z
weights and contribute exact zeros), so the kernel is fastest on
layouts that keep each column's live slots first, as
``build_column_sort`` and ``banded_column_resort`` do; any other layout
is still summed correctly.

``dense_onehot_contract`` returns (Nz, Nrb, n_off * 2 * C).  On CPU
tensors it runs the plain PyTorch version (``dense_onehot_contract_plain``:
V materialized, then a segmented sum by ``index_add_``); on CUDA tensors
it launches the kernel or raises.
"""
import torch

from ..utils import kernels


def dense_onehot_contract_plain(geom, channel_vals, meta, Nrb):
    """Plain PyTorch version of K3 (same signature and result)."""
    from .sorted_deposit import _build_V, _contract
    return _contract(geom["ir_buf"], _build_V(geom, channel_vals, meta), Nrb)


def dense_smem_bytes(esize, C, n_off, Rt):
    """Dynamic shared memory of one block: the (Rt, n_off*2*C)
    accumulator and the ring of staged tiles (as csrc/dense_deposit.cu
    reckons it)."""
    return (kernels.align16(esize * Rt * n_off * 2 * C)
            + kernels.NSTAGE * kernels.stage_bytes(esize, C + n_off + 2, 1))


def dense_operands(geom, channel_vals, meta):
    """(name, tensor, dtype, shape) of every operand of K3, in the order
    of the kernel's pointer table (the output goes between the fixed
    operands and the per-offset z weights)."""
    dtype = channel_vals.dtype
    Nz, K, C = channel_vals.shape
    fixed = [("channel_vals", channel_vals, dtype, (Nz, K, C)),
             ("sr0_m0", geom["sr0_m0"], dtype, (Nz, K)),
             ("sr0_mh", geom["sr0_mh"], dtype, (Nz, K)),
             ("below_axis", geom["below_axis"], torch.bool, (Nz, K)),
             ("ir_buf", geom["ir_buf"], torch.int64, (Nz, K)),
             ("ok", geom["ok"], dtype, (Nz, K)),
             ("is_mode0", meta["is_mode0"], torch.bool, (C,)),
             ("flip", meta["flip"], dtype, (C,))]
    zw = [(f"zw[{o}]", t, dtype, (Nz, K)) for o, t in enumerate(geom["zw"])]
    return fixed, zw


def dense_onehot_contract(geom, channel_vals, meta, Nrb):
    """K3: (Nz, Nrb, n_off*2*C), blocks ordered (offset, corner, channel)
    as ``torch.cat(_build_V(...), dim=2)``."""
    dev = channel_vals.device
    if dev.type == "cpu":
        return dense_onehot_contract_plain(geom, channel_vals, meta, Nrb)
    if dev.type != "cuda":
        raise ValueError(f"dense deposit: unsupported device {dev}")
    dtype = channel_vals.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dense deposit: unsupported dtype {dtype}")
    if channel_vals.dim() != 3:
        raise ValueError("dense deposit: channel_vals is not (Nz, K, C)")
    Nz, K, C = channel_vals.shape
    n_off = len(geom["zw"])
    if n_off > kernels.MAX_OFF:
        raise ValueError(f"dense deposit: more than {kernels.MAX_OFF} z "
                         f"offsets in one window")
    fixed, zw = dense_operands(geom, channel_vals, meta)
    for name, t, dt, shape in fixed + zw:
        kernels.check_operand("dense deposit", name, t, dev, dt, shape)
    out = torch.empty((Nz, Nrb, n_off * 2 * C), dtype=dtype, device=dev)

    esize = channel_vals.element_size()
    Rt, _ = kernels.pick_row_tiling(
        Nrb, lambda rt: dense_smem_bytes(esize, C, n_off, rt))
    lib = kernels.library("dense_deposit")
    fn = (lib.dense_contract_f32 if dtype == torch.float32
          else lib.dense_contract_f64)
    table = kernels.pointer_table([t for _, t, _, _ in fixed] + [out]
                                  + [t for _, t, _, _ in zw])
    code = fn(table, Nz, K, C, n_off, Nrb, Rt,
              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(code, "dense deposit")
    kernels.count_launch(dense_onehot_contract)
    return out


#: Kernel launches (CUDA path only), read by the chip smoke run; in a
#: decomposed run also counted per slab (kernels.count_launch).
dense_onehot_contract.launches = 0
dense_onehot_contract.launches_by_slab = {}

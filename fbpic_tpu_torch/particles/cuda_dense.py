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

``dense_onehot_contract`` returns (Nz, Nrb, n_off * 2 * C).  On CPU
tensors it runs the plain PyTorch version (``dense_onehot_contract_plain``:
V materialized, then a segmented sum by ``index_add_``); on CUDA tensors
it launches the kernel or raises.
"""
import torch

from ..utils.kernels import library, check_launch


def dense_onehot_contract_plain(geom, channel_vals, meta, Nrb):
    """Plain PyTorch version of K3 (same signature and result)."""
    from .sorted_deposit import _build_V, _contract
    return _contract(geom["ir_buf"], _build_V(geom, channel_vals, meta), Nrb)


def _pick_tiling(lib, esize, C, n_off, Nrb, W, smem_budget=100_000):
    """Fewest channel tiles whose shared memory fits the budget."""
    for n_tiles in range(1, W + 1):
        Wt = -(-W // n_tiles)
        if (lib.dense_contract_smem_bytes(esize, C, n_off, Nrb, Wt)
                <= smem_budget and Wt <= 1024):
            return Wt, n_tiles
    raise ValueError(f"dense deposit: no channel tiling fits Nrb={Nrb}")


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
    Nz, K, C = channel_vals.shape
    n_off = len(geom["zw"])
    rows = [geom["sr0_m0"], geom["sr0_mh"], geom["below_axis"],
            geom["ir_buf"]] + list(geom["zw"])
    for t in rows + [meta["is_mode0"], meta["flip"]]:
        if t.device != dev:
            raise ValueError("dense deposit: operands on different devices")
    for t in rows:
        if tuple(t.shape) != (Nz, K):
            raise ValueError(f"dense deposit: operand shape {tuple(t.shape)}"
                             f" is not ({Nz}, {K})")
    if tuple(meta["is_mode0"].shape) != (C,) \
            or tuple(meta["flip"].shape) != (C,):
        raise ValueError("dense deposit: channel metadata is not (C,)")
    W = n_off * 2 * C

    def stack(ts):
        return torch.stack([t.to(dtype) for t in ts], dim=1).contiguous()

    chan = channel_vals.permute(0, 2, 1).contiguous()       # (Nz, C, K)
    zw = stack(geom["zw"])
    geo = stack([geom["sr0_m0"], geom["sr0_mh"], geom["below_axis"]])
    ir = geom["ir_buf"].to(torch.int32).contiguous()
    cmeta = torch.stack([meta["is_mode0"].to(dtype),
                         meta["flip"].to(dtype)]).contiguous()   # (2, C)
    out = torch.empty((Nz, Nrb, W), dtype=dtype, device=dev)

    lib = library("dense_deposit")
    esize = 4 if dtype == torch.float32 else 8
    Wt, n_tiles = _pick_tiling(lib, esize, C, n_off, Nrb, W)
    fn = (lib.dense_contract_f32 if dtype == torch.float32
          else lib.dense_contract_f64)
    args = [chan, zw, geo, ir, cmeta, out]
    code = fn(*[a.data_ptr() for a in args], Nz, K, C, n_off, Nrb, Wt,
              n_tiles, -(-Wt // 32) * 32,
              torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "dense deposit")
    dense_onehot_contract.launches += 1
    return out


#: Kernel launches (CUDA path only), read by the chip smoke run.
dense_onehot_contract.launches = 0

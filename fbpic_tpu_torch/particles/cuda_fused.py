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

``fused_onehot_contract`` keeps the fbpic_tpu signature and returns
(Nz, Nrb, W).  On CPU tensors it runs the plain PyTorch version
(``fused_onehot_contract_plain``: V materialized, then a segmented sum
by ``index_add_``); on CUDA tensors it launches the kernel or raises.
"""
import torch

from ..utils.kernels import library, check_launch
from .deposit import NGUARD, _channel_meta


def _operands(geom, channels, span, dph, ph_b, wj, Nm):
    """Flat list of the contraction's inputs, for checking."""
    return ([channels, dph, ph_b, wj, geom["sr0_m0"], geom["sr0_mh"],
             geom["below_axis"], geom["ir_buf"], span["u_a"], span["u_b"],
             span["bn"]] + list(geom["zw"]) + list(span["zw_a"])
            + list(span["zw_b"]))


def fused_onehot_contract_plain(geom, channels, meta, span, dph, ph_b, wj,
                                ruyten, Nm, Nz, Nr, n_offJ, n_offD):
    """Plain PyTorch version of K1 (same signature and result)."""
    from .sorted_deposit import _build_V, _build_V_span_diff, _contract
    metaD = _channel_meta(Nm, 1, [+1.0], channels.dtype, channels.device)
    blocks = (_build_V(geom, channels, meta)
              + _build_V_span_diff(span, dph, ph_b, wj, metaD, ruyten,
                                   n_blocks=n_offD))
    return _contract(geom["ir_buf"], blocks, Nr + 2 * NGUARD)


def _pick_tiling(lib, esize, CJ, nJ, CD, nD, Nrb, W, smem_budget=100_000):
    """Fewest channel tiles whose shared memory fits the budget."""
    for n_tiles in range(1, W + 1):
        Wt = -(-W // n_tiles)
        smem = lib.fused_contract_smem_bytes(esize, CJ, nJ, CD, nD, Nrb, Wt)
        if smem <= smem_budget and Wt <= 1024:
            return Wt, n_tiles
    raise ValueError(f"fused deposit: no channel tiling fits Nrb={Nrb}")


def fused_onehot_contract(geom, channels, meta, span, dph, ph_b, wj,
                          ruyten, Nm, Nz, Nr, n_offJ, n_offD):
    """K1: (Nz, Nrb, W) with the J blocks in [..., :n_offJ*2*CJ] and
    the d(rho) blocks after them."""
    if channels.device.type == "cpu":
        return fused_onehot_contract_plain(
            geom, channels, meta, span, dph, ph_b, wj, ruyten, Nm, Nz, Nr,
            n_offJ, n_offD)
    if channels.device.type != "cuda":
        raise ValueError(f"fused deposit: unsupported device "
                         f"{channels.device}")
    dtype = channels.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused deposit: unsupported dtype {dtype}")
    K, CJ = channels.shape[1], channels.shape[2]
    CD = dph.shape[2]
    for t in _operands(geom, channels, span, dph, ph_b, wj, Nm):
        if t.device != channels.device:
            raise ValueError("fused deposit: operands on different devices")
        if tuple(t.shape[:2]) != (Nz, K):
            raise ValueError(f"fused deposit: operand shape {tuple(t.shape)}"
                             f" is not ({Nz}, {K}, ...)")
    if len(geom["zw"]) != n_offJ or len(span["zw_a"]) != n_offD \
            or len(span["zw_b"]) != n_offD or CJ != 3 * (2 * Nm - 1) \
            or CD != 2 * Nm - 1 or tuple(ruyten.shape) != (2, Nr + 1):
        raise ValueError("fused deposit: inconsistent channel counts")
    Nrb = Nr + 2 * NGUARD
    W = n_offJ * 2 * CJ + n_offD * 2 * CD

    def rows_first(t):                      # (Nz, K, C) -> (Nz, C, K)
        return t.to(dtype).permute(0, 2, 1).contiguous()

    def stack(ts):
        return torch.stack([t.to(dtype) for t in ts], dim=1).contiguous()

    chJ = rows_first(channels)
    zwJ = stack(geom["zw"])
    rows = stack([geom["sr0_m0"], geom["sr0_mh"], geom["below_axis"],
                  span["u_a"], span["u_b"], wj])
    ir = geom["ir_buf"].to(torch.int32).contiguous()
    bn = span["bn"].to(torch.int32).contiguous()
    dphs, phbs = rows_first(dph), rows_first(ph_b)
    zwa, zwb = stack(span["zw_a"]), stack(span["zw_b"])
    tables = ruyten.to(dtype).contiguous()
    def meta_rows(m):                       # (2, C): [is_mode0, flip]
        return torch.stack([m["is_mode0"].to(dtype),
                            m["flip"].to(dtype)]).contiguous()

    metaJ = meta_rows(meta)
    metaD = meta_rows(_channel_meta(Nm, 1, [+1.0], dtype, channels.device))
    out = torch.empty((Nz, Nrb, W), dtype=dtype, device=channels.device)

    lib = library("fused_deposit")
    esize = 4 if dtype == torch.float32 else 8
    Wt, n_tiles = _pick_tiling(lib, esize, CJ, n_offJ, CD, n_offD, Nrb, W)
    threads = -(-Wt // 32) * 32
    fn = (lib.fused_contract_f32 if dtype == torch.float32
          else lib.fused_contract_f64)
    args = [chJ, zwJ, rows, ir, bn, dphs, phbs, zwa, zwb, tables, metaJ,
            metaD, out]
    code = fn(*[a.data_ptr() for a in args], Nz, K, CJ, n_offJ, CD, n_offD,
              Nrb, Nr + 1, Wt, n_tiles, threads,
              torch.cuda.current_stream(channels.device).cuda_stream)
    check_launch(code, "fused deposit")
    fused_onehot_contract.launches += 1
    return out


#: Kernel launches (CUDA path only), read by the chip smoke run.
fused_onehot_contract.launches = 0

"""K1's plain PyTorch version, frozen from fbpic_tpu_torch's
particles/cuda_fused.py: ``fused_onehot_contract`` runs it on every
device (the CUDA kernel is not part of the reference)."""
import torch

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


def fused_onehot_contract(geom, channels, meta, span, dph, ph_b, wj,
                          ruyten, Nm, Nz, Nr, n_offJ, n_offD):
    """K1's contraction by its plain version, on every device."""
    return fused_onehot_contract_plain(
        geom, channels, meta, span, dph, ph_b, wj, ruyten, Nm, Nz, Nr,
        n_offJ, n_offD)

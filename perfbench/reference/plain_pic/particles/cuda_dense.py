"""K3's plain PyTorch version, frozen from fbpic_tpu_torch's
particles/cuda_dense.py: ``dense_onehot_contract`` runs it on every
device (the CUDA kernel is not part of the reference)."""


def dense_onehot_contract_plain(geom, channel_vals, meta, Nrb):
    """Plain PyTorch version of K3 (same signature and result)."""
    from .sorted_deposit import _build_V, _contract
    return _contract(geom["ir_buf"], _build_V(geom, channel_vals, meta), Nrb)


def dense_onehot_contract(geom, channel_vals, meta, Nrb):
    """K3's contraction by its plain version, on every device."""
    return dense_onehot_contract_plain(geom, channel_vals, meta, Nrb)

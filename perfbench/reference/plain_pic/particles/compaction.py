"""Front-pack a masked subset of particle arrays into a small buffer.

The packing of fbpic_tpu's ``topk_compact`` (fbpic_tpu's
particles/compaction.py): the selected elements in ascending index
order, the first ``buffer_size`` of them, zero fill past the selection.
fbpic_tpu gets that order from ``lax.top_k`` of an index score because a
scatter serializes on the TPU; here the running count of the selection
(a cumsum) is searched for each buffer slot, so every channel is one
gather of ``buffer_size`` elements.  Neither step reads anything back to
the host (no boolean-mask indexing, no ``nonzero``).

Used by ionization (the newborn electrons) and by the per-level routing
of their buffer.  Reference analog: the CUDA prefix-sum compaction in
FBPIC's fbpic/particles/elementary_process/cuda_numba_utils.py:60-120.
"""
import torch


def topk_compact(mask, buffer_size, arrays):
    """Pack ``arrays[name][mask]`` (in index order) into
    ``(buffer_size,)`` buffers, zero-filled past the selection.

    mask: bool (N,); buffer_size: int; arrays: dict name -> (N,) tensor
    (any dtype).  Returns (bufs, n_selected, n_taken): the buffers, the
    selected count and the count that fit (0-d int64 tensors on the
    mask's device; the selected beyond ``buffer_size`` are dropped)."""
    N = mask.shape[0]
    dev = mask.device
    count = torch.cumsum(mask.to(torch.int64), 0)
    slot = torch.arange(1, buffer_size + 1, device=dev)
    if N == 0:
        n_selected = torch.zeros((), dtype=torch.int64, device=dev)
        src = torch.zeros(buffer_size, dtype=torch.int64, device=dev)
    else:
        n_selected = count[-1]
        # Buffer slot j takes the element where the count reaches j + 1
        src = torch.clamp(torch.searchsorted(count, slot), max=N - 1)
    got = slot <= n_selected
    bufs = {}
    for name, arr in arrays.items():
        if N == 0:
            bufs[name] = torch.zeros(buffer_size, dtype=arr.dtype,
                                     device=dev)
            continue
        bufs[name] = torch.where(got, arr[src],
                                 torch.zeros((), dtype=arr.dtype,
                                             device=dev))
    n_taken = torch.clamp(n_selected, max=buffer_size)
    return bufs, n_selected, n_taken

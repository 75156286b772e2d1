"""Published peaks of the cards the benchmark runs on (NVIDIA H100 SXM
data sheet: dense rates, no sparsity, at the full 700 W power limit).
A roofline share is stated against these, with the card's power limit
printed beside it; a card that is not in the table gets no share."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flop_per_s": 67e12,       # float32 outside the tensor cores
    },
}


def peak(kind):
    """The peaks of the card named ``kind`` (torch.cuda.get_device_name),
    or None."""
    return PEAKS.get(kind)


def least_seconds(n_bytes, n_flops, card):
    """The least time the card needs to move n_bytes and do n_flops
    (float32), and which of the two bounds it ("bytes" or
    "operations")."""
    t_bytes = n_bytes / card["hbm_bytes_per_s"]
    t_ops = n_flops / card["fp32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

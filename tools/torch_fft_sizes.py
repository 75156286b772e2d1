"""Card against CPU roundoff of torch.fft in float64 for the z lengths of
chip_smoke.py phase 25: the float64 resident mesh's slab (146 = 2 x 73)
and its single-device control (392 = 2^3 x 7^2), plus a few neighbours.

For each length n: a random complex128 (2, n, 16) array from a numpy
seed, fft then ifft along z, and the largest |card - CPU| relative to
the largest |CPU| value of each result.  Run on a machine with a CUDA
card: ``python3 tools/torch_fft_sizes.py``.
"""
import json

import numpy as np
import torch

SIZES = (146, 148, 144, 392, 73, 128)


def main():
    rng = np.random.default_rng(0)
    out = {}
    for n in SIZES:
        x = rng.standard_normal((2, n, 16)) + 1j * rng.standard_normal(
            (2, n, 16))
        cpu = torch.as_tensor(x)
        card = cpu.cuda()
        row = {}
        for name, fn in (("fft", torch.fft.fft), ("ifft", torch.fft.ifft)):
            a = fn(cpu, dim=1)
            b = fn(card, dim=1).cpu()
            row[name] = float((a - b).abs().max() / a.abs().max())
        # the round trip on each device against the input
        for dev, t in (("cpu", cpu), ("card", card)):
            back = torch.fft.ifft(torch.fft.fft(t, dim=1), dim=1).cpu()
            row[f"round_trip_{dev}"] = float((back - cpu).abs().max()
                                             / cpu.abs().max())
        out[n] = row
        print(n, row, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

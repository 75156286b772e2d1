"""The work counters against hand counts at a small size, and the
roofline share of a synthetic trace."""
import pytest

from perfbench import peaks, registry
from perfbench.readers import Context, roofline_share
from perfbench.trace import Trace

GRID = dict(Nz=10, Nr=4, Nm=2)     # 3 real values a cell and component
LIVE = 100


def test_k1_hand_count():
    n_bytes, n_flops = registry.roofline("k1").work(GRID, LIVE)
    # 100 particles x 8 floats + 4 components x 3 x 10 x 4 cells, 4 B each
    assert n_bytes == 100 * 8 * 4 + 4 * 3 * 40 * 4 == 5120
    # 4 corners x 4 components x 3 mode values x (mul + add)
    assert n_flops == 100 * 4 * 4 * 3 * 2 == 9600


def test_k2_hand_count():
    n_bytes, n_flops = registry.roofline("k2").work(GRID, LIVE)
    assert n_bytes == 100 * 9 * 4 + 6 * 3 * 40 * 4 == 6480
    assert n_flops == 100 * 4 * 6 * 3 * 2 == 14400


def test_k3_counts_a_steps_j_and_rho_once():
    assert registry.roofline("k3").work(GRID, LIVE) == \
        registry.roofline("k1").work(GRID, LIVE)


def test_least_seconds_takes_the_larger_bound():
    card = peaks.peak("NVIDIA H100 80GB HBM3")
    t, what = peaks.least_seconds(3.35e12, 1.0, card)
    assert (t, what) == (pytest.approx(1.0), "bytes")
    t, what = peaks.least_seconds(1.0, 67e12 * 2, card)
    assert (t, what) == (pytest.approx(2.0), "operations")
    assert peaks.peak("some other card") is None


def _ctx(kernel_us, steps=2, kind="NVIDIA H100 80GB HBM3"):
    counter = registry.roofline("k2")
    ks = [(10.0 * i, 10.0 * i + kernel_us, counter.KERNEL + "<float>")
          for i in range(steps)]
    tr = Trace({0: ks}, [], wall_s=1.0, steps=steps)
    return Context(trace=tr, cards=[0], chunks=1, rollbacks=0, grid=GRID,
                   live=LIVE, kind=kind)


def test_roofline_share_of_a_synthetic_trace():
    n_bytes, _ = registry.roofline("k2").work(GRID, LIVE)
    least_us = n_bytes / 3.35e12 * 1e6
    share = roofline_share(_ctx(kernel_us=4 * least_us), "k2")
    assert share == pytest.approx(25.0)


def test_roofline_share_is_silent_without_the_kernel_or_the_card():
    assert roofline_share(_ctx(1.0), "k1") is None
    assert roofline_share(_ctx(1.0, kind="cpu"), "k2") is None

"""The traced stretch's reductions on synthetic intervals: busy time is
the union of kernel intervals (overlapping streams count once), and the
readers take their numbers from it."""
import pytest

from perfbench import registry
from perfbench.readers import Context
from perfbench.trace import Trace, breakdown, merged, union_us


def test_union_of_disjoint_intervals_is_their_sum():
    assert union_us([(0, 1), (2, 4), (10, 11)]) == 4


def test_union_counts_overlapping_streams_once():
    # two streams: [0, 10) and [5, 15) overlap by 5; [12, 13) inside
    assert union_us([(5, 15), (0, 10), (12, 13)]) == 15
    assert union_us([(0, 10), (0, 10)]) == 10
    assert union_us([]) == 0


def test_merged_gives_disjoint_sorted_intervals():
    assert merged([(3, 4), (0, 2), (1, 3), (6, 7)]) == [[0, 4], [6, 7]]


def trace():
    # card 0, 2 steps in 100 us of wall time: kernels on two overlapping
    # streams cover [0, 30) and [50, 60); the host launches a graph at
    # 0 and waits in a synchronize from 30 to 50
    kernels = {0: [(0, 20, "gather_sorted_kernel"),
                   (10, 30, "fft_r2c_kernel"),
                   (50, 60, "vectorized_elementwise_kernel")]}
    host = [(0, 2, "cudaGraphLaunch"), (30, 50, "cudaStreamSynchronize"),
            (0, 100, "step"), (2, 3, "cudaLaunchKernel")]
    return Trace(kernels, host, wall_s=100e-6, steps=2)


def ctx(tr):
    return Context(trace=tr, cards=[0], chunks=4, rollbacks=1,
                   grid=dict(Nz=10, Nr=4, Nm=2), live=100,
                   kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("name,value", [
    ("idle_share", 60.0), ("device_ms_per_step", 0.02),
    ("launches_per_step", 1.5), ("host_launch_calls_per_step", 1.0),
    ("rollback_share", 25.0), ("spectral_ms_per_step", 0.01),
])
def test_readers_on_a_synthetic_trace(name, value):
    got = registry.metric_reader(name).read(ctx(trace()))
    assert got == pytest.approx(value)


def test_readers_find_nothing_without_a_trace_or_kernel():
    assert registry.metric_reader("idle_share").read(ctx(None)) is None
    assert registry.metric_reader("sort_scan_ms_per_step").read(
        ctx(trace())) is None
    assert registry.metric_reader("k3_roofline").read(ctx(trace())) is None


def test_breakdown_names_ops_and_idle_gaps():
    b = breakdown(trace(), 0)
    ops = dict(b["device_ops"])
    assert ops["gather_sorted_kernel"] == pytest.approx(20e-6)
    assert len(b["device_ops"]) == 3
    # the one gap, [30, 50), lies inside the synchronize (the innermost
    # host event around its middle)
    assert b["idle_gaps"] == [["cudaStreamSynchronize",
                               pytest.approx(20e-6)]]


def two_cards():
    # card 0 computes [0, 40) and waits for card 1 in a flag kernel over
    # [40, 80), copies [80, 90); card 1 computes [0, 70), copies [70, 75)
    kernels = {0: [(0, 40, "fused_contract_kernel"),
                   (40, 80, "flag_kernel"), (80, 90, "copy_parts_kernel")],
               1: [(0, 70, "gather_sorted_kernel"),
                   (70, 75, "copy_parts_kernel")]}
    return Trace(kernels, [], wall_s=100e-6, steps=1)


@pytest.mark.parametrize("name,value", [
    # card 0: 50 us of work (the wait is idle), card 1: 75 us
    ("idle_share.4card", 100 * (0.5 + 0.25) / 2),
    ("device_ms_per_step.4card", 0.075),
    ("peer_wait_ms_per_step", 0.04),
    ("peer_copy_ms_per_step", 0.01),
])
def test_card_readers_on_a_synthetic_trace(name, value):
    ctx = Context(trace=two_cards(), cards=[0, 1], chunks=1, rollbacks=0,
                  grid=dict(Nz=10, Nr=4, Nm=2), live=100,
                  kind="NVIDIA H100 80GB HBM3")
    assert registry.metric_reader(name).read(ctx) == pytest.approx(value)

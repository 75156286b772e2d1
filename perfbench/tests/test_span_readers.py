"""The step-phase readers (metrics/_spans.py and the metrics that use
it) on synthetic traces: the card's kernels partitioned by the
program's marker kernels, K1 left out of deposit_prep, the idle gaps
inside a replayed step, the coverage, and None without markers."""
import pytest

from perfbench import registry
from perfbench.readers import Context
from perfbench.trace import Trace

SPAN_READERS = ("reorder_ms_per_step", "interp_push_ms_per_step",
                "deposit_prep_ms_per_step", "deposit_prep_launches_per_step",
                "fields_ms_per_step", "copy_back_ms_per_step",
                "exchange_ms_per_step", "graph_gap_ms_per_step",
                "span_coverage")

#: A step() call of two steps: (name, microseconds, idle microseconds
#: before it); a name "@x" is the marker of span x, which runs 1 us
CALL = [
    ("@prepare", 1, 0), ("deposit_rho_prev", 4, 0),
    ("@chunk_in", 1, 1), ("Memcpy HtoD", 1, 0),
    # step 1, an exchange step: its table row first, 1 us idle inside
    # its damp span
    ("@row", 1, 2), ("index_select_kernel", 1, 0),
    ("@exchange", 1, 0), ("remove_and_inject", 4, 0),
    ("@reorder", 1, 0), ("radixSortKVInPlace", 4, 0),
    ("@interpolate", 1, 0), ("gather_sorted_kernel", 2, 0),
    ("@push", 1, 0), ("vectorized_elementwise_kernel", 2, 0),
    ("@deposit", 1, 0), ("index_put_kernel", 2, 0),
    ("fused_contract_kernel", 4, 0),
    ("@unpad", 1, 0), ("unrolled_elementwise_kernel", 1, 0),
    ("@sources", 1, 0), ("fft_r2c", 4, 0),
    ("@maxwell", 1, 0), ("gemm_kernel", 3, 0),
    ("@window", 1, 0), ("roll_kernel", 1, 0),
    ("@damp", 1, 0), ("damp_a", 1, 0), ("damp_b", 2, 1),
    ("@store", 1, 0), ("copy_kernel", 2, 0),
    # 7 us between the two graphs, before the row read that opens the
    # second; step 2: 2 us idle before its store
    ("@row", 1, 7), ("index_select_kernel", 1, 0),
    ("@reorder", 1, 0), ("radixSortKVInPlace", 3, 0),
    ("@interpolate", 1, 0), ("gather_sorted_kernel", 1, 0),
    ("@push", 1, 0), ("vectorized_elementwise_kernel", 1, 0),
    ("@deposit", 1, 0), ("fused_contract_kernel", 2, 0),
    ("index_put_kernel", 1, 0),
    ("@unpad", 1, 0), ("unrolled_elementwise_kernel", 1, 0),
    ("@sources", 1, 0), ("fft_c2r", 1, 0),
    ("@maxwell", 1, 0), ("gemm_kernel", 1, 0),
    ("@window", 1, 0), ("roll_kernel", 1, 0),
    ("@damp", 1, 0), ("damp_a", 1, 0),
    ("@store", 1, 2), ("copy_kernel", 1, 0),
    ("@chunk_out", 1, 3), ("Memcpy DtoH", 1, 0),
]


def timeline(items, t=0.0):
    out = []
    for name, dur, idle in items:
        t += idle
        out.append((t, t + dur, "fbpic_span_" + name[1:]
                    if name.startswith("@") else name))
        t += dur
    return out


def ctx(kernels, steps=2):
    return Context(trace=Trace({0: kernels}, [], wall_s=1e-3, steps=steps),
                   cards=[0], chunks=1, rollbacks=0,
                   grid=dict(Nz=10, Nr=4, Nm=2), live=100,
                   kind="NVIDIA H100 80GB HBM3")


def read(name, c):
    return registry.metric_reader(name).read(c)


@pytest.mark.parametrize("name,value", [
    # step 1 4 us + step 2 3 us, over 2 steps, in ms
    ("reorder_ms_per_step", 3.5e-3),
    # interpolate + push + unpad: 5 + 3 us
    ("interp_push_ms_per_step", 4e-3),
    # the deposit span without fused_contract_kernel: 2 + 1 us, 2 kernels
    ("deposit_prep_ms_per_step", 1.5e-3),
    ("deposit_prep_launches_per_step", 1.0),
    # sources + maxwell + window + damp: 11 + 4 us
    ("fields_ms_per_step", 7.5e-3),
    # the table rows and the stores: 2 + 3 us
    ("copy_back_ms_per_step", 2.5e-3),
    # one exchange step in two
    ("exchange_ms_per_step", 2e-3),
    # 1 + 2 us idle inside the steps; the 7 us between the graphs (up
    # to the next step's row marker) and the gaps around the call's
    # spans are left out
    ("graph_gap_ms_per_step", 1.5e-3),
    ("span_coverage", 100.0),
])
def test_span_readers_on_a_synthetic_call(name, value):
    assert read(name, ctx(timeline(CALL))) == pytest.approx(value)


def test_the_spans_partition_the_steps():
    """The step spans' readers and K1's time add up to the steps' busy
    time, markers left out: every kernel of a step is in one span."""
    c = ctx(timeline(CALL))
    parts = sum(read(n, c) for n in (
        "reorder_ms_per_step", "interp_push_ms_per_step",
        "deposit_prep_ms_per_step", "fields_ms_per_step",
        "copy_back_ms_per_step", "exchange_ms_per_step"))
    k1_ms, _ = c.trace.kernel_s(0, lambda n: "fused_contract_kernel" in n)
    k1_ms *= 1e3 / c.trace.steps
    # the steps' kernels but markers: 33 + 15 us, over 2 steps
    assert parts + k1_ms == pytest.approx(48e-3 / 2)


def test_k1_and_k3_are_left_out_of_deposit_prep():
    call = [(n.replace("fused_contract_kernel", "dense_contract_kernel"),
             d, i) for n, d, i in CALL]
    c = ctx(timeline(call))
    assert read("deposit_prep_ms_per_step", c) == pytest.approx(1.5e-3)
    assert read("deposit_prep_launches_per_step", c) == 1.0


def test_a_kernel_before_the_first_marker_is_in_no_span():
    early = [(0.0, 10.0, "vectorized_elementwise_kernel")]
    c = ctx(early + timeline(CALL, t=10.0))
    # named 54 us of 64
    assert read("span_coverage", c) == pytest.approx(100 * 54 / 64)
    assert read("reorder_ms_per_step", c) == pytest.approx(3.5e-3)


def test_overlapping_kernels_of_a_span_count_once():
    call = timeline(CALL)
    s, e, _ = next(k for k in call if k[2] == "radixSortKVInPlace")
    c = ctx(call + [(s + 1, e - 1, "radixSortKVInPlace")])
    assert read("reorder_ms_per_step", c) == pytest.approx(3.5e-3)


def test_a_step_without_a_store_span_has_no_window():
    """An eager step (a rolled-back chunk) ends in no store span: its
    gaps are not a graph's."""
    call = [k for k in CALL if k[0] not in ("@store", "copy_kernel")]
    assert read("graph_gap_ms_per_step", ctx(timeline(call))) == 0.0


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_without_markers(name):
    plain = [k for k in timeline(CALL) if not k[2].startswith("fbpic_")]
    assert read(name, ctx(plain)) is None
    assert read(name, ctx([])) is None
    none = Context(trace=None, cards=[0], chunks=1, rollbacks=0,
                   grid=dict(Nz=10, Nr=4, Nm=2), live=100,
                   kind="NVIDIA H100 80GB HBM3")
    assert read(name, none) is None

"""The port's spans (utils/profiling.py): host spans ``fbpic::<name>``
and the device spans' marker kernels ``fbpic_span_<name>``
(csrc/spans.cu), which the benchmark's step-phase readers read.

On the CPU:
- no marker or host-span name falls into a kernel class of the
  benchmark (perfbench/kernel_classes.py), names a roofline kernel or
  is a host launch call, and csrc/spans.cu holds the markers in the
  order of ``DEVICE_SPANS``;
- ``recording()`` is true inside torch.profiler and false outside;
- a small LWFA chunk through the chunk runner's CPU path, under the CPU
  profiler, emits the host spans in order, one ``replay`` a step, and
  launches no marker;
- without a profiler ``span`` returns a context that adds no event;
- ``GraphMarkers.follow`` switches the marker nodes only when the
  profiler's state changed since its last call.

On the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_spans.py``): a traced chunk of a replayed LWFA shows
each span's marker once a step, in order; once the profiler has exited,
the next call turns every marker node off (a traced replay that does
not switch them runs none) and the run stays bit for bit that of a
twin captured without markers; the launch counters read the same; and
the trace holds as many events on the card as the twin's (no host
span, no marker) plus the markers.  On two cards (slabs, one a card),
each card's markers run on that card.
"""
import os
import re
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _lwfa(device, dtype, small):
    """A resident LWFA with a moving window, continuous injection and
    open z (tests/test_torch_cuda.py's golden-wake box on the card; a
    box of internal Nz 64 on the CPU)."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c, e, m_e
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    if small:
        Nz, Nr, zmax, zmin, rmax = 24, 16, 2.e-6, -4.e-6, 10.e-6
        kw = dict(n_order=16, n_guard=8, n_damp={"z": 8, "r": 32},
                  exchange_period=4)
        plasma = dict(n=5.e24, p_zmin=-3.e-6, p_rmax=9.e-6, p_nr=2)
        laser = dict(a0=0.5, waist=4.e-6, tau=8.e-15, z0=-1.e-6)
    else:
        Nz, Nr, zmax, zmin, rmax = 400, 24, 30.e-6, -10.e-6, 20.e-6
        kw = dict(n_order=32)
        plasma = dict(n=4.e24, p_zmin=24.e-6, p_rmax=14.e-6, p_nr=1)
        laser = dict(a0=1.0, waist=8.e-6, tau=10.e-15, z0=20.e-6)
    sim = Simulation(Nz, zmax, Nr, rmax, 2, (zmax - zmin) / Nz / c,
                     zmin=zmin, boundaries={"z": "open", "r": "reflective"},
                     random_seed=0, verbose_level=0, device=device,
                     dtype=dtype, **kw)
    sim.use_fused_deposit = True         # force the resident layout
    sim.add_new_species(q=-e, m=m_e, p_zmax=500.e-6, p_rmin=0., p_nz=1,
                        p_nt=4, sort_K=256, continuous_injection=True,
                        **plasma)
    add_laser_pulse(sim, GaussianLaser(**laser))
    sim.set_moving_window(v=c)
    assert sim.species_configs[0].resident
    return sim


def _fbpic_events(prof):
    """(name, start, end) of the host spans a profiler recorded, in
    start order."""
    return sorted(((ev.name, ev.time_range.start, ev.time_range.end)
                   for ev in prof.events() if ev.name.startswith("fbpic::")),
                  key=lambda e: (e[1], -e[2]))


# ---------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------

def _span_names():
    from fbpic_tpu_torch.utils import profiling as pr
    return ([pr.MARKER_PREFIX + n for n in pr.DEVICE_SPANS]
            + [pr.HOST_PREFIX + n for n in pr.HOST_SPANS])


@pytest.mark.parametrize("name", _span_names())
def test_span_names_stay_out_of_the_benchmarks_classes(name):
    from perfbench import registry
    from perfbench.kernel_classes import HOST_LAUNCH_CALLS, \
        KERNEL_CLASSES, kernel_class
    assert kernel_class(name) == "other"
    assert not any(re.search(pat, name) for _, pat in KERNEL_CLASSES)
    for k in ("k1", "k2", "k3"):
        assert registry.roofline(k).KERNEL not in name
    assert name not in HOST_LAUNCH_CALLS


def test_spans_cu_holds_the_markers_in_order():
    from fbpic_tpu_torch.utils import kernels, profiling
    src = (kernels.CSRC / "spans.cu").read_text()
    block = re.search(r"#define FBPIC_SPANS\(X\)(.*?)\n\n", src, re.S)
    assert tuple(re.findall(r"X\((\w+)\)", block.group(1))) \
        == profiling.DEVICE_SPANS
    assert "spans" in kernels.SOURCES
    assert len(set(profiling.DEVICE_SPANS)) == len(profiling.DEVICE_SPANS)


def test_recording_follows_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.utils.profiling import recording
    assert not recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert recording()
    assert not recording()


def test_span_without_a_profiler_adds_no_event():
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.utils import profiling
    off = profiling.span("chunk")
    assert off is profiling.span("replay")       # one shared null context
    with off:
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert _fbpic_events(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("chunk"):
            torch.ones(4).sum()
    assert [e[0] for e in _fbpic_events(prof)] == ["fbpic::chunk"]


def test_host_spans_of_a_chunk_in_order():
    """Simulation.step(6) of a small LWFA: one chunk of the runner's CPU
    path (its graph body called directly), the step spans nested in
    order, one ``replay`` a step, no ``capture`` and no marker."""
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.utils import kernels
    sim = _lwfa("cpu", torch.float32, small=True)
    n = 6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.step(n)
    events = _fbpic_events(prof)
    names = [e[0][len("fbpic::"):] for e in events]
    assert names == (["step", "prepare", "refresh_eb", "rho_prev", "write",
                      "plan", "chunk", "plan", "stage_in"] + ["replay"] * n
                     + ["read", "stage_out", "write"])
    step, prepare, chunk = events[0], events[1], events[6]
    for _, s, e in events[1:]:
        assert step[1] <= s <= e <= step[2]
    for _, s, e in events[2:4]:
        assert prepare[1] <= s <= e <= prepare[2]
    for _, s, e in events[7:7 + 2 + n + 2]:
        assert chunk[1] <= s <= e <= chunk[2]
    replays = [e for e in events if e[0] == "fbpic::replay"]
    assert all(a[2] <= b[1] for a, b in zip(replays, replays[1:]))
    assert sim.iteration == n and "spans" not in kernels._libs


def test_graph_markers_switch_only_on_a_change(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    from fbpic_tpu_torch.utils.profiling import GraphMarkers
    switched = []
    monkeypatch.setattr(GraphMarkers, "_set",
                        staticmethod(lambda entry, on:
                                     switched.append((entry, on))))
    markers = GraphMarkers()
    markers._graphs = ["a", "b"]
    markers.follow()
    assert switched == [] and not markers.on
    with profile(activities=[ProfilerActivity.CPU]):
        markers.follow()
        markers.follow()
    assert switched == [("a", True), ("b", True)] and markers.on
    markers.follow()
    markers.follow()
    assert switched[2:] == [("a", False), ("b", False)] and not markers.on
    markers.clear()
    assert markers._graphs == []


# ---------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------

class _deterministic:
    """torch's deterministic algorithms while the block runs (index_add_
    a sorted segment sum): two runs of the same steps give the same
    bits."""

    def __enter__(self):
        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])


def _launches():
    from fbpic_tpu_torch.utils import kernels
    return {fn.__name__: n for fn, n in kernels.launch_counts().items()}


def _traced(run, cards=(0,)):
    """The events on ``cards`` of ``run()`` under torch.profiler: (name,
    start, card) in start order.  The profiler has recorded a kernel on
    each card before ``run()`` starts: a trace's first kernel on a
    card went unrecorded twice (a first process on a four-card machine),
    which would take a call's first marker with it."""
    from torch.profiler import ProfilerActivity, profile
    for card in cards:
        torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for card in cards:
            torch.ones(1, device=f"cuda:{card}").sum()
            torch.cuda.synchronize(card)
        run()
        for card in cards:
            torch.cuda.synchronize(card)
    cuda_type = torch.autograd.DeviceType.CUDA
    return sorted(((ev.name, ev.time_range.start, ev.device_index)
                   for ev in prof.events() if ev.device_type == cuda_type),
                  key=lambda e: e[1])


def _calls(sim, ep, monkeypatch):
    """The calls both twins make: a warm-up that captures every variant,
    a traced call of two exchange periods, an untraced one, and a traced
    one whose runner does not follow the profiler (its marker nodes stay
    as the untraced call left them); returns the two traced calls'
    events on the card and each call's launch counts."""
    from fbpic_tpu_torch.utils.profiling import GraphMarkers
    counts, before = [], _launches()

    def counted(run):
        nonlocal before
        out = run()
        after = _launches()
        counts.append({k: after[k] - before.get(k, 0) for k in after})
        before = after
        return out
    counted(lambda: sim.step(ep + 1))
    variants = dict(sim._multi_step.graphs)
    events = counted(lambda: _traced(lambda: sim.step(2 * ep)))
    counted(lambda: sim.step(ep))
    with monkeypatch.context() as m:
        m.setattr(GraphMarkers, "follow", lambda self: None)
        held = counted(lambda: _traced(lambda: sim.step(ep)))
    assert sim._multi_step.graphs == variants     # nothing captured
    return events, held, counts


def _markers(events):
    from fbpic_tpu_torch.utils.profiling import MARKER_PREFIX
    return [n[len(MARKER_PREFIX):] for n, _, _ in events
            if n.startswith(MARKER_PREFIX)]


def _step_markers(exchange):
    """A replayed step's markers, in order."""
    from fbpic_tpu_torch.utils.profiling import STEP_SPANS
    return [n for n in STEP_SPANS if n != "exchange" or exchange]


@pytest.mark.cuda
def test_markers_on_the_card(cuda, monkeypatch):
    from fbpic_tpu_torch.core import graph as graph_module
    from fbpic_tpu_torch.core import step as step_module
    from fbpic_tpu_torch.core.graph import state_tensors
    from fbpic_tpu_torch.utils import profiling
    from fbpic_tpu_torch.utils.profiling import CALL_SPANS
    with _deterministic():
        sim = _lwfa(cuda, torch.float32, small=False)
        ep = sim.exchange_period
        assert ep > 1
        it0 = ep + 1
        events, held, counts = _calls(sim, ep, monkeypatch)
        # the twin: no marker captured or launched, no host span
        twin = _lwfa(cuda, torch.float32, small=False)
        with monkeypatch.context() as m:
            for mod in (step_module, graph_module):
                m.setattr(mod, "mark", lambda name, device: None)
            m.setattr(profiling, "_RecordFunctionFast",
                      lambda name: profiling._OFF)
            twin_events, twin_held, twin_counts = _calls(twin, ep,
                                                         monkeypatch)
    markers = _markers(events)
    expected = ["prepare", "chunk_in"]
    for it in range(it0, it0 + 2 * ep):
        expected += _step_markers(it % ep == 0)
    expected.append("chunk_out")
    assert markers == expected
    # the twin's trace holds the same events but the markers
    assert _markers(twin_events) == _markers(twin_held) == []
    assert len(events) == len(twin_events) + len(markers)
    # the launch counters count no marker
    assert counts == twin_counts
    assert counts[1]["fused_onehot_contract"] == 2 * ep
    assert counts[1]["gather_sorted"] == 2 * ep
    # the untraced call after the profiler exited turned every marker
    # node off: a traced replay that does not switch them runs none
    assert _markers(held) == list(CALL_SPANS)
    assert len(held) == len(twin_held) + len(CALL_SPANS)
    assert sim.iteration == twin.iteration
    for a, b in zip(state_tensors(sim.state), state_tensors(twin.state)):
        assert torch.equal(a, b)


def _slab_lwfa():
    """tests/test_torch_cuda.py's slab LWFA: float32 on the card, the
    resident layout, an exchange every 4 steps."""
    from fbpic_tpu_torch import Simulation
    from fbpic_tpu_torch.constants import c
    from fbpic_tpu_torch.lpa_utils.laser import add_laser_pulse, \
        GaussianLaser
    nz, zmax, zmin = 130, 12.e-6, -4.e-6
    sim = Simulation(nz, zmax, 20, 10.e-6, 2, (zmax - zmin) / nz / c,
                     p_zmin=2.e-6, p_zmax=200.e-6, p_rmin=0.,
                     p_rmax=9.e-6, p_nz=1, p_nr=2, p_nt=4, n_e=5.e24,
                     zmin=zmin, n_order=16,
                     boundaries={"z": "open", "r": "reflective"},
                     exchange_period=4, random_seed=0, verbose_level=0)
    add_laser_pulse(sim, GaussianLaser(a0=0.5, waist=4.e-6,
                                       tau=8.e-15, z0=6.e-6))
    sim.set_moving_window(v=c)
    return sim


@pytest.mark.cuda
def test_markers_on_each_of_two_cards(cuda):
    """2 slabs, one a card, one CUDA graph a card: a traced chunk shows
    each card's markers on that card -- its own chunk_in and chunk_out,
    and its slab's step markers once a step, in order, between them (a
    slab's exchange block opens ``exchange`` before its migration, and
    the step's own exchange continues it)."""
    from fbpic_tpu_torch.parallel import distribute_simulation
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    run = distribute_simulation(_slab_lwfa(), devices=["cuda:0", "cuda:1"],
                                n_guard=24)
    ep = 4
    run.step(2 * ep)
    assert run.runner.graphs
    it0, n = run.iteration, 2 * ep
    events = _traced(lambda: run.step(n), cards=(0, 1))
    expected = ["chunk_in"]
    for it in range(it0, it0 + n):
        expected += _step_markers(it % ep == 0)
    expected.append("chunk_out")
    for card in (0, 1):
        names = _markers([e for e in events if e[2] == card])
        collapsed = [a for k, a in enumerate(names)
                     if k == 0 or a != names[k - 1]]
        assert collapsed == expected, (card, names)

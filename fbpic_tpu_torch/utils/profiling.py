"""Tracing (fbpic_tpu/utils/profiling.py): a torch.profiler trace of a
code block, and the spans that say which part of a run each stretch of
it is.

- ``trace(logdir)`` records the block (host activity, and the card's
  kernels where CUDA is present) into ``logdir/trace.json``, a Chrome /
  Perfetto trace.
- Host spans, ``span(name)``: a range ``fbpic::<name>`` on the
  profiler's host timeline, on the clock of its device timeline
  (``HOST_SPANS``).  It is a plain function range, never a user
  annotation, so the profiler mirrors no event of it onto the card.
- Device spans, ``mark(name, device)``: the empty kernel
  ``fbpic_span_<name>`` (csrc/spans.cu), one launch on the current
  stream.  A marker opens its span, which lasts until the card's next
  marker (``DEVICE_SPANS``): a kernel belongs to the span of the latest
  marker that started before it.  Every step replays a captured CUDA
  graph, so the step's markers (``STEP_SPANS``) are kernel nodes of the
  graphs, captured always; ``GraphMarkers`` turns a runner's marker
  nodes on while a profiler records and off otherwise, without capturing
  again.  Outside a capture a marker launches only while a profiler
  records.

While no profiler records, ``span`` and ``mark`` cost one test each and
a graph's disabled marker nodes launch nothing.

Usage::

    from fbpic_tpu_torch.utils.profiling import trace
    with trace("fbpic-trace"):
        sim.step(100)
    # then open fbpic-trace/trace.json at ui.perfetto.dev
"""
import contextlib
import ctypes
import os
import threading

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

from . import kernels

#: The device spans of a step, in its order (core/step.py
#: ``make_step_fn``; ``row``, the step's scalars read from the chunk's
#: table, and ``store``: core/graph.py, the graph's step body)
STEP_SPANS = ("row", "exchange", "reorder", "interpolate", "push",
              "deposit", "unpad", "sources", "maxwell", "window", "damp",
              "store")
#: The device spans that a step() call launches from the host: the
#: preparation, the copy into a chunk runner's buffers, its read and
#: the copy out
CALL_SPANS = ("prepare", "chunk_in", "chunk_out")
#: Every device span, in csrc/spans.cu's order (a marker's id)
DEVICE_SPANS = STEP_SPANS + CALL_SPANS
MARKER_PREFIX = "fbpic_span_"
#: The host spans: a step() call, its preparation, the host's plan (the
#: chunk runner chosen for the call; a chunk's table), a chunk and its
#: parts (``rollback``: the chunk through the eager loop), a graph
#: variant's warm-up and capture, the writers; inside the preparation,
#: its E/B refresh and its rho_prev deposit
HOST_SPANS = ("step", "prepare", "plan", "chunk", "stage_in", "replay",
              "read", "stage_out", "rollback", "capture", "write",
              "refresh_eb", "rho_prev")
HOST_PREFIX = "fbpic::"

_MARKER_ID = {name: i for i, name in enumerate(DEVICE_SPANS)}
_OFF = contextlib.nullcontext()
#: Markers launched inside a capture, by card (``GraphMarkers`` checks
#: that a graph holds as many)
_captured = {}
_captured_lock = threading.Lock()


def recording():
    """Whether a torch profiler records now."""
    return _profiler_enabled()


@contextlib.contextmanager
def trace(logdir):
    """torch.profiler trace around a code block, written to
    ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def span(name):
    """The host span ``fbpic::<name>`` around a block while a profiler
    records; a context that does nothing otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(HOST_PREFIX + name)


def _card(device):
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def mark(name, device):
    """Open device span ``name`` on ``device`` (a torch.device): its
    marker on the device's current stream, with the device current,
    inside a CUDA graph capture always, elsewhere only while a profiler
    records; nothing off CUDA."""
    if device.type != "cuda":
        return
    capturing = torch.cuda.is_current_stream_capturing()
    if not (capturing or _profiler_enabled()):
        return
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        kernels.check_launch(kernels.library("spans").span_launch(
            _MARKER_ID[name], stream), f"the {name} marker")
    if capturing:
        card = _card(device)
        with _captured_lock:
            _captured[card] = _captured.get(card, 0) + 1


def _captured_on(card):
    with _captured_lock:
        return _captured.get(card, 0)


def keep_graph():
    """A new torch.cuda.CUDAGraph that keeps its cudaGraph_t after the
    capture (``keep_graph``), for ``GraphMarkers`` to find its marker
    nodes in."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as err:
        raise RuntimeError(
            f"torch {torch.__version__}'s CUDAGraph has no keep_graph: the "
            f"device spans' markers could not be turned off in the "
            f"captured graphs") from err


class GraphMarkers:
    """The marker nodes of a chunk runner's CUDA graphs: on together
    while a profiler records, off otherwise (``follow``, at the start of
    each call).  A disabled node (``cudaGraphNodeSetEnabled``) is an
    empty node: the replay launches nothing for it."""

    def __init__(self):
        #: (card, cudaGraphExec_t, its marker nodes, their count)
        self._graphs = []
        self.on = False

    def follow(self):
        """Markers on if a profiler records now, else off: set only
        where that changed since the last call."""
        on = _profiler_enabled()
        if on != self.on:
            for entry in self._graphs:
                self._set(entry, on)
            self.on = on

    @contextlib.contextmanager
    def capturing(self, graphs):
        """Around the capture of ``graphs`` ({card: graph of
        ``keep_graph``}): the markers loaded on each card first (a
        module is not loaded inside a capture); after it, each graph
        instantiated, its marker nodes found -- as many as the capture
        launched on its card, else it raises -- and set as the others
        are."""
        lib = kernels.library("spans")
        for card in graphs:
            with torch.cuda.device(card):
                kernels.check_launch(lib.span_load(), "loading the markers")
        before = {card: _captured_on(_card(torch.device(card)))
                  for card in graphs}
        yield
        for card, graph in graphs.items():
            launched = _captured_on(_card(torch.device(card))) - before[card]
            with torch.cuda.device(card):
                graph.instantiate()
                self._add(card, graph, launched)

    def _add(self, card, graph, launched):
        lib = kernels.library("spans")
        found = ctypes.c_int()
        kernels.check_launch(lib.span_find(graph.raw_cuda_graph(), None, 0,
                                           ctypes.byref(found)),
                             "finding the markers")
        if found.value != launched:
            raise RuntimeError(
                f"a captured graph holds {found.value} marker nodes, but "
                f"its capture launched {launched} markers")
        n = found.value
        nodes = (ctypes.c_void_p * n)()
        kernels.check_launch(lib.span_find(graph.raw_cuda_graph(), nodes, n,
                                           ctypes.byref(found)),
                             "finding the markers")
        entry = (card, graph.raw_cuda_graph_exec(), nodes, n)
        self._graphs.append(entry)
        if not self.on:
            self._set(entry, False)

    @staticmethod
    def _set(entry, on):
        card, exec_, nodes, n = entry
        if n == 0:
            return
        with torch.cuda.device(card):
            kernels.check_launch(kernels.library("spans").span_set_enabled(
                exec_, nodes, n, int(on)), "switching the markers")

    def clear(self):
        """Forget the graphs (a runner's release)."""
        self._graphs = []

// Device spans: one empty marker kernel per phase of a step or call
// (fbpic_tpu_torch/utils/profiling.py).
//
// Replaces no Pallas kernel.  Every step of the port replays a captured
// CUDA graph, so a host range around a phase runs only at capture time;
// these markers are part of the graph instead and show on the device
// timeline of a torch.profiler trace.  A marker opens its span, which
// lasts until the card's next marker: one launch per boundary.
//
// - ``span_launch``: the marker ``id`` (``<<<1, 1>>>``, no operand) on
//   a stream; inside a stream capture it becomes a kernel node of the
//   graph.  ``id`` is the marker's place in FBPIC_SPANS, the order of
//   profiling.py's DEVICE_SPANS.
// - ``span_load``: every marker loaded on the current device, before a
//   capture (a lazily loaded module is not loaded inside one).
// - ``span_find``: the marker nodes of a captured graph, found by their
//   kernel function (a node of another module's kernel, which this
//   runtime cannot name, is skipped).
// - ``span_set_enabled``: those nodes on or off in the graph's
//   executable (``cudaGraphNodeSetEnabled``): a disabled node is an
//   empty node and launches nothing, so a replay without a profiler
//   runs no marker and the graph is never captured again.
//
// Each marker takes one thread for about a microsecond a launch; the
// nodes, while enabled, also add their launch gaps to the graph.
#include <cuda_runtime.h>

#include <vector>

#define FBPIC_SPANS(X)                                                     \
  X(row) X(exchange) X(reorder) X(interpolate) X(push) X(deposit)          \
  X(unpad) X(sources) X(maxwell) X(window) X(damp) X(store) X(prepare)     \
  X(chunk_in) X(chunk_out)

#define FBPIC_SPAN_KERNEL(name) \
  extern "C" __global__ void fbpic_span_##name() {}
FBPIC_SPANS(FBPIC_SPAN_KERNEL)
#undef FBPIC_SPAN_KERNEL

namespace {

#define FBPIC_SPAN_ENTRY(name) &fbpic_span_##name,
void (*const kMarkers[])() = {FBPIC_SPANS(FBPIC_SPAN_ENTRY)};
#undef FBPIC_SPAN_ENTRY

constexpr int kCount = sizeof(kMarkers) / sizeof(kMarkers[0]);

}  // namespace

extern "C" int span_load() {
  for (int i = 0; i < kCount; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(
        &attr, reinterpret_cast<const void*>(kMarkers[i]));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" int span_launch(int id, void* stream) {
  if (id < 0 || id >= kCount)
    return static_cast<int>(cudaErrorInvalidValue);
  kMarkers[id]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The marker nodes of ``graph`` (a cudaGraph_t): their count into
// ``found``, and the first ``capacity`` of them into ``nodes``
// (cudaGraphNode_t).
extern "C" int span_find(void* graph, void** nodes, int capacity,
                         int* found) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  *found = 0;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> all(n);
  if (n > 0) {
    err = cudaGraphGetNodes(g, all.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (cudaGraphNode_t node : all) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(node, &type) != cudaSuccess ||
        type != cudaGraphNodeTypeKernel)
      continue;
    cudaKernelNodeParams params;
    if (cudaGraphKernelNodeGetParams(node, &params) != cudaSuccess) {
      cudaGetLastError();  // another module's kernel: not a marker
      continue;
    }
    for (int i = 0; i < kCount; ++i) {
      if (params.func != reinterpret_cast<void*>(kMarkers[i])) continue;
      if (*found < capacity) nodes[*found] = node;
      ++*found;
      break;
    }
  }
  return static_cast<int>(cudaSuccess);
}

// ``n`` marker nodes of the graph that ``exec`` (a cudaGraphExec_t) was
// instantiated from, enabled (``on``) or disabled in it.
extern "C" int span_set_enabled(void* exec, void** nodes, int n, int on) {
  cudaGraphExec_t e = static_cast<cudaGraphExec_t>(exec);
  for (int i = 0; i < n; ++i) {
    cudaError_t err = cudaGraphNodeSetEnabled(
        e, static_cast<cudaGraphNode_t>(nodes[i]), on ? 1u : 0u);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

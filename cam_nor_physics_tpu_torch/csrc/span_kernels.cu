// Marker kernels of the port's spans (utils/timing.py::span).
//
// While a profiler records, `span(name)` enqueues one of these at its
// entry and one at its exit, on the current stream. A marker does nothing:
// it is a <<<1, 1>>> launch whose name says which span and which edge it
// marks, span_mark_kernel<S, E> with S the span's index in timing.SPANS
// and E 0 at the entry and 1 at the exit. Launched inside a CUDA graph's
// capture, a marker is a node of the graph, so the profiler records it in
// every replay on the device's clock, beside the kernels between the two
// edges: the kernels of the span. A host span exists only while a graph
// is captured; its markers are there in every replay.
//
// Each (S, E) is an instantiation of its own, so that the name carries
// both numbers; cam_span_mark picks it from a table built at compile time
// for every S below kMaxSpans. It checks the launch as every entry point
// of the port does and returns the cudaError.
#include <cuda_runtime.h>

#include <utility>

constexpr int kMaxSpans = 32;

template <int S, int E>
__global__ void span_mark_kernel() {}

namespace {

template <int S>
cudaError_t launch_mark(int edge, cudaStream_t stream) {
  if (edge == 0) {
    span_mark_kernel<S, 0><<<1, 1, 0, stream>>>();
  } else {
    span_mark_kernel<S, 1><<<1, 1, 0, stream>>>();
  }
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(int, cudaStream_t);

template <int... S>
cudaError_t launch_span(int span, int edge, cudaStream_t stream,
                        std::integer_sequence<int, S...>) {
  static constexpr LaunchFn table[] = {&launch_mark<S>...};
  return table[span](edge, stream);
}

}  // namespace

extern "C" int cam_span_mark(int span, int edge, void* stream) {
  if (span < 0 || span >= kMaxSpans || (edge != 0 && edge != 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_span(span, edge, (cudaStream_t)stream,
                          std::make_integer_sequence<int, kMaxSpans>{});
}

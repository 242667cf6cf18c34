// Span marks: empty kernels that put the begin and the end of a program
// span (utils/metrics.py's trace_annotation) on the device timeline.
//
// A frame replayed from a CUDA graph runs no Python, so a host range
// around its stages marks nothing at replay. A mark is a kernel launched on
// the current stream: inside a capture it becomes a node of the graph and
// runs, in stream order, at every replay, between the work before it and
// the work after it. span_mark<ID, END> is instantiated for every span id
// below SPAN_IDS and END 0 (begin) or 1 (end), so the device trace names
// each mark, "span_mark<ID, END>", with no reliance on order alone. The
// kernel reads and writes nothing: one block of one thread, ~1-2 µs a node
// in a replayed graph.

#include <cuda_runtime.h>

#include <utility>

constexpr int SPAN_IDS = 32;

template <int ID, int END>
__global__ void span_mark() {}

namespace {

// The instances as kernel pointers, entry 2·id + end.
template <int... I>
const void* span_kernel(int i, std::integer_sequence<int, I...>) {
  static const void* const table[] = {
      reinterpret_cast<const void*>(&span_mark<I / 2, I % 2>)...};
  return table[i];
}

}  // namespace

extern "C" {

// Launches span_mark<id, end> on `stream`. id in [0, SPAN_IDS), end 0 or
// 1, else cudaErrorInvalidValue and nothing launched.
cudaError_t ekf_span_mark(int id, int end, void* stream) {
  if (id < 0 || id >= SPAN_IDS || (end != 0 && end != 1))
    return cudaErrorInvalidValue;
  const void* fn =
      span_kernel(2 * id + end, std::make_integer_sequence<int, 2 * SPAN_IDS>());
  cudaError_t err = cudaLaunchKernel(fn, dim3(1), dim3(1), nullptr, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"

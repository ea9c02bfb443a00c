// Span marks: one do-nothing kernel per boundary of the train step.
//
// No TPU kernel stands behind this file. A range recorded on the host
// (``record_function``, NVTX) is recorded once, when a CUDA graph is
// captured, and never again when the graph replays; a kernel launched into
// the capture is a node of the graph and runs on every replay. So each
// boundary of a step is a kernel of its own name, ``gs_span_<name>``, and
// the profiler's device trace holds it on the same clock as every other
// kernel of the step, with no synchronise and no read on the host. Each
// mark starts a segment that ends at the next one.
//
// Launched from ``utils/runtime.mark`` only while spans are on
// (``runtime.spanning()``); with them off this library is never built or
// loaded. ``gs_span_mark(id, stream)`` launches mark ``id`` of the ordered
// tuple ``SPANS`` in utils/runtime.py: the cases below follow that order.
//
// A mark's name holds no name of another kernel of the port, nor "sort",
// "scan" or "nccl", so that a reader of the trace that classifies kernels
// by name never takes a mark for one of those.

#include <cuda_runtime.h>

#define GS_SPAN(name) \
  __global__ void gs_span_##name() {}

GS_SPAN(preprocess)
GS_SPAN(binning)
GS_SPAN(composite)
GS_SPAN(loss)
GS_SPAN(loss_bwd)
GS_SPAN(composite_bwd)
GS_SPAN(preprocess_bwd)
GS_SPAN(adam)
GS_SPAN(stats)
GS_SPAN(end)

extern "C" int gs_span_mark(int id, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (id) {
    case 0: gs_span_preprocess<<<1, 1, 0, s>>>(); break;
    case 1: gs_span_binning<<<1, 1, 0, s>>>(); break;
    case 2: gs_span_composite<<<1, 1, 0, s>>>(); break;
    case 3: gs_span_loss<<<1, 1, 0, s>>>(); break;
    case 4: gs_span_loss_bwd<<<1, 1, 0, s>>>(); break;
    case 5: gs_span_composite_bwd<<<1, 1, 0, s>>>(); break;
    case 6: gs_span_preprocess_bwd<<<1, 1, 0, s>>>(); break;
    case 7: gs_span_adam<<<1, 1, 0, s>>>(); break;
    case 8: gs_span_stats<<<1, 1, 0, s>>>(); break;
    case 9: gs_span_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// An IF node on device state inside a CUDA graph captured by PyTorch, for
// Hopper (sm_90a) and CUDA >= 12.4.
//
// Replaces: the lax.cond all-slots-done early-out of the ring decode chunk,
// omnia_tpu/engine/programs.py, _mk_step_body(ring=True)'s body. It is
// control flow, not a Pallas kernel: XLA turns that cond into a conditional
// of its own program; here the captured chunk gets a conditional node.
//
// PyTorch builds of this card's toolkit have no Python API for conditional
// nodes, so the node is written here, inside a stream capture that PyTorch
// runs:
//   omnia_graph_if_begin(capture stream, flags, n, body stream)
//     1. creates a conditional handle on the graph being captured;
//     2. captures set_if_any: one block that ORs flags[0..n) (a bool
//        tensor on the card, the slots' active flags) and sets the handle,
//        so the branch reads device state and the host reads nothing;
//     3. adds an IF node after it and makes the node the capture stream's
//        dependency, so what the stream captures next runs after the node;
//     4. starts capturing `body stream` into the node's body graph.
//   The caller enqueues the body's work on `body stream`, then
//   omnia_graph_if_end(body stream) ends that capture. A body that is skipped
//   costs the one set_if_any block and the node.
// What bounds it: one launch of a 32-thread block per node (a few
// microseconds of latency); it reads n bytes.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_any(cudaGraphConditionalHandle handle, const unsigned char* flags,
                           int n) {
  unsigned int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) any |= flags[i] ? 1u : 0u;
  any = __any_sync(0xffffffffu, any) ? 1u : 0u;
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, any);
}

}  // namespace

extern "C" int omnia_graph_if_begin(void* capture_stream, const void* flags, int n,
                                    void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(capture_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if_any<<<1, 32, 0, s>>>(handle, static_cast<const unsigned char*>(flags), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr,
                                       0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int omnia_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// Streams of the runtime this library links, for the captures: PyTorch's
// stream pool hands its streams out round robin, so two of them may be one.
extern "C" int omnia_stream_create(void** out) {
  cudaStream_t s;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = err == cudaSuccess ? static_cast<void*>(s) : nullptr;
  return err;
}

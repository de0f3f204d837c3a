// Region stamps of the decode step's device timeline, for Hopper (sm_90a).
//
// Replaces: nothing of the JAX package, which times its programs from the
// host. A captured ring step is a conditional node's body, which accepts
// kernel nodes and refuses event record nodes (graph_cond.cu), so the
// step's regions are timed by a kernel of their own:
//   omnia_stamp(stream, out)
//     launches one thread on `stream` that writes %globaltimer (the GPU's
//     nanosecond timer) into *out, a uint64 on the card. Launched on a
//     capturing stream it becomes a kernel node of the graph being
//     captured, an IF body included, so a skipped step stamps nothing.
// Stream order makes the stamp run after the work enqueued before it and
// before the work enqueued after it: the difference of two stamps is the
// device time of what ran between them, the stamp's own launch included.
// What bounds it: one launch of one thread (a few microseconds of latency);
// it writes 8 bytes.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_globaltimer(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}

}  // namespace

extern "C" int omnia_stamp(void* stream, void* out) {
  stamp_globaltimer<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

// Length-aware GQA decode attention over a slot-contiguous KV cache, for
// Hopper (sm_90a).
//
// Replaces: omnia_tpu/ops/decode_attention.py, _decode_kernel with
// quantized=False, reached through decode_gqa_attention (K1). Same
// function: one query row per slot and head, softmax(q.k^T * D^-0.5) over
// the rows 0..positions[b] of that slot, times v; f32 accumulation, masked
// value -1e30, result acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it on an H100: bytes. Each call must read the K and V rows
// it attends to, sum_b (pos_b + 1) * Hkv * D * 2 * sizeof(dtype), plus q
// and the output; at 3.35 TB/s that is the floor. The arithmetic is
// ~4 * G flops per K/V element read, far below the card's ratio of
// operations to bytes, so the tensor cores would buy nothing here.
//
// What the design does about it:
// - Rows past positions[b] are never read: each block loads positions[b]
//   itself, clamps its row range to it, and a split that lies wholly past
//   it returns at once. Traffic follows the real context, not S.
// - Each K/V row is loaded once per (slot, KV head) and used for all G
//   query heads of the group; K/V are never repeated.
// - The TPU kernel walks S in order on one core and carries (m, l, acc)
//   across grid steps. Hopper's blocks run in parallel in no order, so S
//   is split (flash-decoding): grid (splits, Hkv, B), one partial
//   (m, l, acc) per split in f32 scratch, then a second kernel combines
//   the splits up to positions[b] / split_rows. At 8 slots x 8 KV heads a
//   1024-row context gives 1024 blocks for 132 SMs instead of 64.
// - A warp takes one row at a time: each lane holds D/32 elements of the
//   row (neighbouring lanes on neighbouring addresses) and the G scores
//   are warp-shuffle sums. Simple and right first; tensor-core tiles,
//   16-byte loads and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int clamp_pos(const int* positions, int b, int S) {
  int pos = positions[b];
  pos = pos < 0 ? 0 : pos;
  return pos > S - 1 ? S - 1 : pos;
}

// Partial pass: block (s, h, b) attends the G query heads of KV head h of
// slot b over rows [s * split_rows, min((s + 1) * split_rows, pos + 1)).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ positions,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int S, int Hkv,
                      int split_rows, int num_splits, float scale) {
  constexpr int EPL = (D + 31) / 32;  // row elements per lane
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = clamp_pos(positions, b, S);
  const int row0 = s * split_rows;
  if (row0 > pos) return;  // wholly past the position: nothing to read
  const int row1 = min(row0 + split_rows, pos + 1);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = Hkv * G;

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      qr[g][e] = d < D ? to_f32(q[((size_t)b * H + h * G + g) * D + d]) : 0.f;
    }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int r = row0 + warp; r < row1; r += kWarps) {
    const size_t base = (((size_t)b * S + r) * Hkv + h) * D;
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      kr[e] = d < D ? to_f32(k[base + d]) : 0.f;
      vr[e] = d < D ? to_f32(v[base + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kr[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float score = dot * scale;
      const float m_new = fmaxf(m[g], score);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(score - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[e];
      m[g] = m_new;
    }
  }

  // Merge the warps' states in shared memory, then write the split's one.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();

  const size_t split_base = ((size_t)b * Hkv + h) * num_splits + s;  // [B,Hkv,NS]
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    part_acc[(split_base * G + g) * D + d] = A;
    if (d == 0) {
      part_m[split_base * G + g] = M;
      part_l[split_base * G + g] = L;
    }
  }
}

// Combine pass: block (h, b) merges the splits 0..pos/split_rows.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const int* __restrict__ positions,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int S, int Hkv, int split_rows, int num_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = clamp_pos(positions, b, S);
  const int used = pos / split_rows + 1;
  const size_t base = ((size_t)b * Hkv + h) * num_splits;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
    for (int s = 0; s < used; ++s) M = fmaxf(M, part_m[(base + s) * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < used; ++s) {
      const float c = __expf(part_m[(base + s) * G + g] - M);
      L += part_l[(base + s) * G + g] * c;
      A += part_acc[((base + s) * G + g) * D + d] * c;
    }
    out[(((size_t)b * Hkv + h) * G + g) * D + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* positions,
                   void* out, float* part_m, float* part_l, float* part_acc,
                   int B, int S, int Hkv, int split_rows, cudaStream_t stream) {
  const int num_splits = (S + split_rows - 1) / split_rows;
  const float scale = rsqrtf((float)D);
  decode_partial_kernel<T, D, G><<<dim3(num_splits, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      positions, part_m, part_l, part_acc, S, Hkv, split_rows, num_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D, G><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      positions, part_m, part_l, part_acc, static_cast<T*>(out), S, Hkv,
      split_rows, num_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* positions, void* out, float* pm, float* pl,
                       float* pa, int B, int S, int Hkv, int split_rows,
                       cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    case 2: return launch<T, D, 2>(q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    case 4: return launch<T, D, 4>(q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    case 8: return launch<T, D, 8>(q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k, const void* v,
                       const int* positions, void* out, float* pm, float* pl,
                       float* pa, int B, int S, int Hkv, int split_rows,
                       cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    case 64: return dispatch_g<T, 64>(G, q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    case 128: return dispatch_g<T, 128>(G, q, k, v, positions, out, pm, pl, pa, B, S, Hkv, split_rows, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B, H, D]; k, v [B, S, Hkv, D]; positions int32 [B]; out [B, H, D];
// part_m, part_l f32 [B, Hkv, ceil(S / split_rows), G]; part_acc the same
// with a trailing D. All contiguous on the device. Returns a cudaError_t.
extern "C" int omnia_decode_gqa_attention(
    const void* q, const void* k, const void* v, const int* positions, void* out,
    float* part_m, float* part_l, float* part_acc, int B, int S, int H, int Hkv,
    int D, int dtype, int split_rows, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || split_rows <= 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, G, q, k, v, positions, out, part_m, part_l,
                                  part_acc, B, S, Hkv, split_rows, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, G, q, k, v, positions, out, part_m,
                                          part_l, part_acc, B, S, Hkv, split_rows, st);
  return (int)cudaErrorInvalidValue;
}

// Length-aware GQA decode attention for Hopper (sm_90a): the body shared
// by the four editions of omnia_tpu/ops/decode_attention.py.
//
//   edition (source)                  KV rows                     replaces
//   decode_attention.cu         (K1)  slot-contiguous, T          _decode_kernel
//   decode_attention_int8.cu    (K2)  slot-contiguous, int8       _decode_kernel, quantized
//   decode_attention_paged.cu   (K3)  page pool + table, T        _decode_kernel_paged
//   decode_attention_paged_int8.cu (K4) page pool + table, int8   _decode_kernel_paged, quantized
//
// Each source instantiates one edition, so the four build in parallel,
// one nvcc each.
//
// Function: one query row per slot and head, softmax(q.k^T * D^-0.5) over
// the rows 0..positions[b] of that slot, times v; f32 accumulation,
// masked value -1e30, result acc / max(l, 1e-30) cast to q's dtype.
// int8 editions (rows scaled by absmax/127 per row and KV head): the
// score is (q.k_int8 * D^-0.5) * k_scale, the pv term is (p * v_scale) *
// v_int8, and l sums the unscaled p -- the JAX kernel's order.
//
// What bounds it on an H100: bytes. Each call must read the K and V rows
// it attends to, sum_b (pos_b + 1) * Hkv * (D * sizeof(row) [+ 4 for the
// scale]) * 2, plus q and the output; at 3.35 TB/s that is the floor. The
// arithmetic is ~4 * G flops per K/V element read, far below the card's
// ratio of operations to bytes, so the tensor cores would buy nothing.
//
// What the design does about it:
// - Rows past positions[b] are never read: each block loads positions[b]
//   itself, clamps its row range to it, and a split that lies wholly past
//   it returns at once. Traffic follows the real context, not S.
// - Paged editions: the split size is the page size, so a block reads
//   exactly one page, table[b, s]; a block past the position returns
//   before it loads its table entry, so no table entry past
//   pos / PAGE_S, and no free or dead page, is ever read (the Hopper form
//   of the TPU kernel's clamped index map).
// - Each K/V row is loaded once per (slot, KV head) and used for all G
//   query heads of the group; K/V are never repeated.
// - The TPU kernel walks S in order on one core and carries (m, l, acc)
//   across grid steps. Hopper's blocks run in parallel in no order, so S
//   is split (flash-decoding): grid (splits, Hkv, B), one partial
//   (m, l, acc) per split in f32 scratch, then a second kernel combines
//   the splits up to positions[b] / split_rows.
// - A warp takes one row at a time and the G scores are warp-shuffle
//   sums. Float rows: lane holds elements lane + 32 e (neighbouring lanes
//   on neighbouring addresses). int8 rows: lane holds the D/32 adjacent
//   elements lane * D/32 + e, read with one packed load (char4 at
//   D = 128); the row's two scales are one broadcast load per warp.
//   With equal split sizes the paged editions do the contiguous ones'
//   arithmetic row for row, so their results are bit-identical.
// Simple and right first; tensor-core tiles, 16-byte loads and a deeper
// pipeline are later work.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace omnia_decode {

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

// Element of the row that lane `lane` holds in its slot `e`.
template <int D, bool Quant>
__device__ __forceinline__ int elem(int lane, int e) {
  constexpr int EPL = (D + 31) / 32;
  return Quant ? lane * EPL + e : lane + 32 * e;
}

// One packed load of a lane's EPL adjacent int8 elements.
template <int EPL>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&out)[EPL]) {
  if constexpr (EPL == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else if constexpr (EPL == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = c.x; out[1] = c.y;
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = p[e];
  }
}

struct Args {
  const void* q;
  const void* k;            // [B, S, Hkv, D], or a pool [P, split_rows, Hkv, D]
  const void* v;
  const float* k_scale;     // int8 editions: [B, S, Hkv] or [P, split_rows, Hkv]
  const float* v_scale;
  const int* table;         // paged editions: [B, num_splits]
  const int* positions;     // [B]
  void* out;                // [B, H, D]
  float* part_m;            // [B, Hkv, num_splits, G]
  float* part_l;
  float* part_acc;          // [B, Hkv, num_splits, G, D]
  int B, S, Hkv, split_rows, num_splits;
  cudaStream_t stream;
};

// Partial pass: block (s, h, b) attends the G query heads of KV head h of
// slot b over rows [s * split_rows, min((s + 1) * split_rows, pos + 1)).
template <typename T, int D, int G, bool Quant, bool Paged>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q,
                      const std::conditional_t<Quant, int8_t, T>* __restrict__ k,
                      const std::conditional_t<Quant, int8_t, T>* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ table, const int* __restrict__ positions,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int S, int Hkv,
                      int split_rows, int num_splits, float scale) {
  constexpr int EPL = (D + 31) / 32;  // row elements per lane
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = clamp_pos(positions, b, S);
  const int row0 = s * split_rows;
  if (row0 > pos) return;  // wholly past the position: nothing to read
  const int row1 = min(row0 + split_rows, pos + 1);
  // First (row, head) index of this split: in the slot's rows, or in its page.
  const size_t split_base =
      Paged ? (size_t)table[(size_t)b * num_splits + s] * split_rows * Hkv
            : ((size_t)b * S + row0) * Hkv;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = Hkv * G;

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = elem<D, Quant>(lane, e);
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
    const size_t row = split_base + (size_t)(r - row0) * Hkv + h;  // (row, head)
    const size_t base = row * D;
    float kr[EPL], vr[EPL];
    float ks = 1.f, vs = 1.f;
    if constexpr (Quant) {
      if (elem<D, Quant>(lane, 0) < D) {
        load_i8<EPL>(k + base + elem<D, Quant>(lane, 0), kr);
        load_i8<EPL>(v + base + elem<D, Quant>(lane, 0), vr);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[e] = vr[e] = 0.f;
      }
      ks = k_scale[row];
      vs = v_scale[row];
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = elem<D, Quant>(lane, e);
        kr[e] = d < D ? to_f32(k[base + d]) : 0.f;
        vr[e] = d < D ? to_f32(v[base + d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kr[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float score = Quant ? dot * scale * ks : dot * scale;
      const float m_new = fmaxf(m[g], score);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(score - m_new);
      const float pv = Quant ? p * vs : p;  // l below sums the unscaled p
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + pv * vr[e];
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
      const int d = elem<D, Quant>(lane, e);
      if (d < D) sm_acc[warp][g][d] = acc[g][e];
    }
  }
  __syncthreads();

  const size_t part = ((size_t)b * Hkv + h) * num_splits + s;  // [B,Hkv,NS]
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
    part_acc[(part * G + g) * D + d] = A;
    if (d == 0) {
      part_m[part * G + g] = M;
      part_l[part * G + g] = L;
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

template <typename T, int D, int G, bool Quant, bool Paged>
cudaError_t launch(const Args& a) {
  using KV = std::conditional_t<Quant, int8_t, T>;
  const float scale = rsqrtf((float)D);
  decode_partial_kernel<T, D, G, Quant, Paged>
      <<<dim3(a.num_splits, a.Hkv, a.B), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
          static_cast<const KV*>(a.v), a.k_scale, a.v_scale, a.table, a.positions,
          a.part_m, a.part_l, a.part_acc, a.S, a.Hkv, a.split_rows, a.num_splits,
          scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D, G><<<dim3(a.Hkv, a.B), kThreads, 0, a.stream>>>(
      a.positions, a.part_m, a.part_l, a.part_acc, static_cast<T*>(a.out), a.S,
      a.Hkv, a.split_rows, a.num_splits);
  return cudaGetLastError();
}

template <typename T, int D, bool Quant, bool Paged>
cudaError_t dispatch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, D, 1, Quant, Paged>(a);
    case 2: return launch<T, D, 2, Quant, Paged>(a);
    case 4: return launch<T, D, 4, Quant, Paged>(a);
    case 8: return launch<T, D, 8, Quant, Paged>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool Quant, bool Paged>
cudaError_t dispatch_d(int D, int G, const Args& a) {
  switch (D) {
    case 16: return dispatch_g<T, 16, Quant, Paged>(G, a);
    case 64: return dispatch_g<T, 64, Quant, Paged>(G, a);
    case 128: return dispatch_g<T, 128, Quant, Paged>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

// The body of every edition's plain C entry point. dtype is q's and the
// output's (0 = float32, 1 = bfloat16); float K/V rows share it. S is
// the logical rows per slot: for the paged editions num_splits *
// split_rows, with split_rows the page size. Returns a cudaError_t.
template <bool Quant, bool Paged>
int entry(const void* q, const void* k, const void* v, const float* k_scale,
          const float* v_scale, const int* table, const int* positions, void* out,
          float* part_m, float* part_l, float* part_acc, int B, int S, int H,
          int Hkv, int D, int dtype, int split_rows, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || split_rows <= 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (Quant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Paged && (table == nullptr || S % split_rows != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, table, positions, out, part_m, part_l,
               part_acc, B, S, Hkv, split_rows, (S + split_rows - 1) / split_rows,
               static_cast<cudaStream_t>(stream)};
  const int G = H / Hkv;
  if (dtype == 0) return (int)dispatch_d<float, Quant, Paged>(D, G, a);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16, Quant, Paged>(D, G, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace omnia_decode

// Every edition exports one function of this signature (pointers into
// contiguous device tensors; unused ones may be null):
//   q [B, H, D]; k, v rows; k_scale, v_scale; table int32 [B, S/split_rows];
//   positions int32 [B]; out [B, H, D]; part_m, part_l f32
//   [B, Hkv, ceil(S / split_rows), G]; part_acc the same with a trailing D.
#define OMNIA_DECODE_ARGS                                                        \
  const void *q, const void *k, const void *v, const float *k_scale,             \
      const float *v_scale, const int *table, const int *positions, void *out,   \
      float *part_m, float *part_l, float *part_acc, int B, int S, int H,        \
      int Hkv, int D, int dtype, int split_rows, void *stream
#define OMNIA_DECODE_CALL                                                        \
  q, k, v, k_scale, v_scale, table, positions, out, part_m, part_l, part_acc, B, \
      S, H, Hkv, D, dtype, split_rows, stream

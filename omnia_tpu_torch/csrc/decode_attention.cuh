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
// ratio of operations to bytes, so the tensor cores would buy nothing. At
// decode sizes the floor is a few microseconds (~15.5 MB of bf16 rows at
// the llama3-8b shape with 8 slots, 4.6 us), so one launch and one HBM
// round trip also count: a design that waits on memory once per row, or
// launches twice, is bound by latency and not by bytes.
//
// What the design does about it:
// - Rows past positions[b] are never read: each block loads positions[b]
//   itself, clamps its row range to it, and a tile that lies wholly past
//   it returns at once. Traffic follows the real context, not S.
// - Grid (tiles, Hkv, B): a tile is kTileRows = 64 rows of one split
//   (split_rows = 64 rows of the contiguous editions, or one page of the
//   paged ones; a page longer than 64 rows is several tiles). Paged
//   editions read page table[b, s]; a block past the position returns
//   before it loads its table entry, so no table entry past
//   pos / page_rows, and no free or dead page, is ever read (the Hopper
//   form of the TPU kernel's clamped index map).
// - Staging: a block first asks for its q elements and issues every byte
//   of its tile as 16-byte cp.async copies into shared memory, in four
//   commit groups (K rows 0-31, K rows 32-63, then V likewise; the int8
//   scales ride with their rows), and only then computes, each part as
//   soon as it has landed: scores run while V is still arriving. The
//   whole live cache is in flight at once (at the llama3-8b shape ~500
//   blocks of 32 KB, all resident: kMinBlocks caps registers so that 4
//   blocks fit an SM), and a block pays one HBM latency, not one per row.
//   Only rows below row1 = min(row0 + 64, pos + 1) are copied, and no loop
//   reads a shared-memory row at or past row1. f32 rows at D = 128 need
//   64 KB: dynamic shared memory, with its limit raised before the launch.
//   (One cp.async.bulk per row, completed on an mbarrier, measured slower:
//   int8 rows are 128-byte copies.)
// - Scores from shared memory with wide reads: a lane holds one chunk of
//   a row (16 bytes: 8 bf16 or 4 f32 elements; 8 int8 elements, since 16
//   would cost 16 * G registers for q) and the same elements of the G
//   query rows in registers; a row's dot products are summed over the
//   D / chunk lanes that hold it by a shuffle tree that halves the heads a
//   lane holds at each step (row_sums). Each K/V row is read once per
//   (slot, KV head) and used for all G query heads; K/V are never repeated.
// - Exact softmax over the tile: one max and one sum per query head over
//   its <= 64 live rows, with no rescale carried from row to row.
// - PV from shared memory: a lane owns one chunk of the output row for the
//   G heads and sums p * v over its share of the rows; the shares are
//   summed by shuffles within a warp, then across warps.
// - Combine in the same launch: each tile writes its (m, l, acc) to f32
//   scratch, and the last tile of (slot, KV head) to finish -- told by an
//   acq_rel atomic counter -- merges tiles 0..(the one holding
//   positions[b]) with up to 16 tiles' loads in flight, writes the output
//   and resets its counter to 0, so the counters are zero between calls.
//   One launch per call, not two.
// With equal tiles (pages of 64 rows) the paged editions do the
// contiguous ones' arithmetic in the same order, so their results are
// bit-identical; every reduction runs in a fixed order, so a result does
// not depend on which block finishes last.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace omnia_decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Blocks an SM must hold (<= 128 registers a thread): the ~500 live tiles
// of the llama3-8b decode shape then run in one wave on 132 SMs.
constexpr int kMinBlocks = 4;
constexpr int kTileRows = 64;  // SPLIT_ROWS in ops/decode_attention.py
constexpr int kParts = 2;      // commit groups per tile and tensor, computed as they land
constexpr float kNegInf = -1e30f;
static_assert(kTileRows == 64, "the softmax gives each lane two rows of a tile");

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Adds one to a (slot, KV head)'s count of finished tiles and returns the
// old count. Release: the partials the block wrote before the barrier are
// visible to whoever reads the new count; acquire: the last tile then sees
// every other tile's partials.
__device__ __forceinline__ int count_tile(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// cp.async.wait_group with a count that is constant once loops unroll.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Sums v[g] (g < G) over the CH lanes that share a row (c = lane % CH).
// Each shuffle halves what a lane holds: it keeps half its values and
// adds its partner's copy of that half, so a row costs about G + log2 CH
// shuffles, not G * log2 CH. On return v[0 .. G / min(G, CH)) hold the
// sums of query heads g0, g0 + 1, ...; the returned value is g0.
template <int G, int CH>
__device__ __forceinline__ int row_sums(float (&v)[G], int c) {
  int g0 = 0, width = G;
#pragma unroll
  for (int o = CH / 2; o > 0; o >>= 1) {
    if (width > 1) {
      const bool upper = (c & o) != 0;
      width /= 2;
#pragma unroll
      for (int i = 0; i < G / 2; ++i) {
        if (i < width) {
          const float send = upper ? v[i] : v[i + width];
          const float keep = upper ? v[i + width] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (upper) g0 += width;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return g0;
}

// W 32-bit words of elements of type E (4 / sizeof(E) a word), as floats.
template <typename E, int W>
__device__ __forceinline__ void unpack(const uint32_t* w, float* x) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (std::is_same_v<E, float>) {
      x[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same_v<E, __nv_bfloat16>) {
      x[2 * i] = __uint_as_float(w[i] << 16);            // element 2i: low half
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j, sign-extended
        x[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
    }
  }
}

// N elements of type E at p (shared memory; 8 or 16 bytes, so aligned), as floats.
template <typename E, int N>
__device__ __forceinline__ void load_chunk(const E* p, float* x) {
  if constexpr (N * sizeof(E) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    unpack<E, 4>(w, x);
  } else {
    static_assert(N * sizeof(E) == 8, "chunks are 8 or 16 bytes");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
    unpack<E, 2>(w, x);
  }
}

// G floats of shared memory at p, in as few loads as their alignment allows.
template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&x)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x; x[i + 1] = f.y; x[i + 2] = f.z; x[i + 3] = f.w;
    }
  } else if constexpr (G == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x; x[1] = f.y;
  } else {
    x[0] = p[0];
  }
}

// Shared memory of one block, in bytes: the K tile (reused for the warps'
// PV sums once the scores are taken), the V tile, the tile's k and v
// scales, the scores (then p; then the combine's m and l) [kTileRows][G],
// and m[G], l[G].
template <typename KV, int D, int G>
struct Smem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kCopies = kRowBytes / 16;  // 16-byte copies per row
  static constexpr int kTileBytes = kTileRows * kRowBytes;
  static constexpr int kRedBytes = kWarps * G * D * 4;
  static constexpr int kV = kTileBytes > kRedBytes ? kTileBytes : kRedBytes;
  static constexpr int kScale = kV + kTileBytes;
  static constexpr int kP = kScale + 2 * kTileRows * 4;
  static constexpr int kM = kP + G * kTileRows * 4;
  static constexpr int kBytes = kM + 2 * G * 4;
  static_assert(kRowBytes % 16 == 0, "rows are whole 16-byte copies");
};

struct Args {
  const void* q;
  const void* k;            // [B, S, Hkv, D], or a pool [P, split_rows, Hkv, D]
  const void* v;
  const float* k_scale;     // int8 editions: [B, S, Hkv] or [P, split_rows, Hkv]
  const float* v_scale;
  const int* table;         // paged editions: [B, num_splits]
  const int* positions;     // [B]
  void* out;                // [B, H, D]
  int* counters;            // [B * Hkv], zero between calls
  float* partials;          // acc [B*Hkv*tiles, G, D], then m and l [B*Hkv*tiles, G]
  int* launch_count;        // null, or a count the launch adds one to
  int B, S, Hkv, split_rows, num_splits, tiles;
  cudaStream_t stream;
};

// Block (x, h, b): tile x of the rows of slot b, KV head h, for the G
// query heads of the group; the last live tile of (b, h) also combines.
template <typename T, int D, int G, bool Quant, bool Paged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_kernel(const T* __restrict__ q,
              const std::conditional_t<Quant, int8_t, T>* __restrict__ k,
              const std::conditional_t<Quant, int8_t, T>* __restrict__ v,
              const float* __restrict__ k_scale, const float* __restrict__ v_scale,
              const int* __restrict__ table, const int* __restrict__ positions,
              T* __restrict__ out, int* __restrict__ counters,
              float* __restrict__ partials, int* __restrict__ launch_count, int S,
              int split_rows, int num_splits, float scale) {
  using KV = std::conditional_t<Quant, int8_t, T>;
  using L = Smem<KV, D, G>;
  // A lane computes on a chunk of N row elements: 16 bytes of T, 8 of
  // int8 (16 int8 would cost 16 * G registers for q alone).
  constexpr int N = Quant ? 8 : 16 / sizeof(KV);
  constexpr int CH = D / N;              // lanes that share a row
  constexpr int CP = L::kCopies;
  static_assert(32 % CH == 0, "a row's lanes lie in one warp");
  constexpr int RG = kThreads / CH;      // rows the block covers per pass
  constexpr int kPartRows = kTileRows / kParts;
  constexpr int kPasses = (kPartRows + RG - 1) / RG;  // passes over a part
  constexpr int kW = G / (G < CH ? G : CH);  // query heads a lane holds after row_sums
  constexpr int kDup = CH / (G < CH ? G : CH);  // lanes holding the same sums
  constexpr int V4 = G * D / 4;          // float4s of a (g, d) output block
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y;
  // A launch given a count (one made inside a captured CUDA graph, whose
  // replays run no host code) adds one to it: block (0, 0, 0), which
  // always runs, since row 0 is never past a position.
  if (launch_count != nullptr && (x | h | b | threadIdx.x) == 0) atomicAdd(launch_count, 1);
  const int tps = (split_rows + kTileRows - 1) / kTileRows;  // tiles per split
  const int s = x / tps, t = x % tps;
  const int pos = clamp_pos(positions, b, S);
  const int row0 = s * split_rows + t * kTileRows;
  if (row0 > pos) return;  // wholly past the position: nothing to read
  const int n = min(min(kTileRows, split_rows - t * kTileRows), pos + 1 - row0);
  // (row, head) index of the tile's first row: in the slot's rows, or in its page.
  const size_t base =
      (Paged ? (size_t)table[(size_t)b * num_splits + s] * split_rows + t * kTileRows
             : (size_t)b * S + row0) * Hkv + h;

  KV* k_s = reinterpret_cast<KV*>(smem);
  KV* v_s = reinterpret_cast<KV*>(smem + L::kV);
  float* ks_s = reinterpret_cast<float*>(smem + L::kScale);
  float* vs_s = ks_s + kTileRows;
  float* p_s = reinterpret_cast<float*>(smem + L::kP);  // [kTileRows][G]
  float* m_s = reinterpret_cast<float*>(smem + L::kM);
  float* l_s = m_s + G;
  float* red_s = reinterpret_cast<float*>(smem);        // [kWarps][G][D], over K

  // This thread's chunk c of rows rg, rg + RG, ...; q's same elements,
  // asked for ahead of the tile.
  const int tid = threadIdx.x;
  const int c = tid % CH, rg = tid / CH;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int kQ16 = N * sizeof(T) / 16;  // 16-byte loads of q per query head
  static_assert(N * sizeof(T) % 16 == 0, "q is read 16 bytes at a time");
  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4* qg =
        reinterpret_cast<const uint4*>(q + (((size_t)b * Hkv + h) * G + g) * D + c * N);
#pragma unroll
    for (int w = 0; w < kQ16; ++w) {
      const uint4 u = __ldg(qg + w);
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
      unpack<T, 4>(words, qr[g] + w * (16 / sizeof(T)));
    }
  }

  // 1. Issue the tile, one commit group per part: K (and k scales) part by
  // part, then V (and v scales).
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const KV* src = kv ? v : k;
    const float* ssrc = kv ? v_scale : k_scale;
    KV* dst = kv ? v_s : k_s;
    float* sdst = kv ? vs_s : ks_s;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int lo = part * kPartRows, hi = min(n, lo + kPartRows);
      for (int i = lo * CP + tid; i < hi * CP; i += kThreads) {
        const int r = i / CP, e = (i % CP) * (16 / sizeof(KV));
        cp_async16(dst + r * D + e, src + (base + (size_t)r * Hkv) * D + e);
      }
      if constexpr (Quant)
        for (int r = lo + tid; r < hi; r += kThreads)
          cp_async4(sdst + r, ssrc + base + (size_t)r * Hkv);
      cp_async_commit();
    }
  }

  // 2. Scores from the K tile, each part as soon as it has landed.
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    cp_async_wait(2 * kParts - 1 - part);
    __syncthreads();
    const int hi = min(n, (part + 1) * kPartRows);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int r = part * kPartRows + pass * RG + rg;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if (r < hi) {
        float kr[N];
        load_chunk<KV, N>(k_s + r * D + c * N, kr);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < N; ++e) dot[g] += qr[g][e] * kr[e];
      }
      const int g0 = row_sums<G, CH>(dot, c);
      if (r < hi && c % kDup == 0)
#pragma unroll
        for (int i = 0; i < kW; ++i)
          p_s[r * G + g0 + i] = Quant ? dot[i] * scale * ks_s[r] : dot[i] * scale;
    }
  }
  __syncthreads();

  // 3. Exact softmax over the tile's live rows, one warp per query head.
  for (int g = warp; g < G; g += kWarps) {
    float* pg = p_s + g;  // row r at pg[r * G]
    const float s0 = lane < n ? pg[lane * G] : kNegInf;
    const float s1 = lane + 32 < n ? pg[(lane + 32) * G] : kNegInf;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p0 = lane < n ? __expf(s0 - m) : 0.f;
    const float p1 = lane + 32 < n ? __expf(s1 - m) : 0.f;
    float l = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane < n) pg[lane * G] = p0;
    if (lane + 32 < n) pg[(lane + 32) * G] = p1;
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;  // the unscaled p
    }
  }

  // 4. PV from the V tile, part by part; the v scale folds into p.
  float acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    cp_async_wait(kParts - 1 - part);
    __syncthreads();
    const int hi = min(n, (part + 1) * kPartRows);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int r = part * kPartRows + pass * RG + rg;
      if (r >= hi) break;
      float vr[N];
      load_chunk<KV, N>(v_s + r * D + c * N, vr);
      float pr[G];
      load_g<G>(p_s + r * G, pr);
      const float vs = Quant ? vs_s[r] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pv = Quant ? pr[g] * vs : pr[g];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][e] += pv * vr[e];
      }
    }
  }
#pragma unroll
  for (int off = CH; off < 32; off <<= 1)  // the warp's row groups
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (lane < CH)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(red_s + (warp * G + g) * D + c * N + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  __syncthreads();

  // 5. This tile's partial, then the last live tile of (b, h) combines.
  const size_t nparts = (size_t)gridDim.x * gridDim.y * gridDim.z;
  float* part_acc = partials;                           // [nparts, G, D]
  float* part_m = partials + nparts * G * D;            // [nparts, G]
  float* part_l = part_m + nparts * G;
  const size_t first = ((size_t)b * Hkv + h) * gridDim.x;  // partial of tile 0
  const float4* red4 = reinterpret_cast<const float4*>(red_s);
  for (int j = tid; j < V4; j += kThreads) {
    float4 A = red4[j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 r = red4[w * V4 + j];
      A.x += r.x; A.y += r.y; A.z += r.z; A.w += r.w;
    }
    reinterpret_cast<float4*>(part_acc + (first + x) * G * D)[j] = A;
  }
  if (tid < G) {
    part_m[(first + x) * G + tid] = m_s[tid];
    part_l[(first + x) * G + tid] = l_s[tid];
  }
  const int sp = pos / split_rows;
  const int used = sp * tps + (pos - sp * split_rows) / kTileRows + 1;  // live tiles
  __syncthreads();  // the block's partial is written before thread 0 counts it
  if (tid == 0) s_last = count_tile(counters + (size_t)b * Hkv + h) == used - 1;
  __syncthreads();
  if (!s_last) return;
  // The live tiles' partials, merged in tile order, a batch of tiles at a
  // time: their m and l go to shared memory (p is spent) while each
  // thread has all its acc loads of the batch in flight at once.
  constexpr int JPT = (V4 + kThreads - 1) / kThreads;  // output float4s per thread
  constexpr int kBatch = 16 / JPT;
  float* ml_s = p_s;  // m [kBatch][G], then l [kBatch][G]
  float M[JPT], Lsum[JPT];
  float4 A[JPT];
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    M[jj] = kNegInf;
    Lsum[jj] = 0.f;
    A[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int y0 = 0; y0 < used; y0 += kBatch) {
    const int nb = min(kBatch, used - y0);
    __syncthreads();  // the previous batch's m and l are read
    for (int i = tid; i < nb * G; i += kThreads) {
      ml_s[i] = __ldcg(part_m + (first + y0) * G + i);
      ml_s[kBatch * G + i] = __ldcg(part_l + (first + y0) * G + i);
    }
    float4 a[JPT][kBatch];
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int j = tid + jj * kThreads;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j < V4 && u < nb)
          a[jj][u] = __ldcg(reinterpret_cast<const float4*>(part_acc + (first + y0 + u) * G * D) + j);
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int j = tid + jj * kThreads, g = 4 * j / D;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j < V4 && u < nb) {
          const float m = ml_s[u * G + g], l = ml_s[(kBatch + u) * G + g];
          const float Mn = fmaxf(M[jj], m);
          const float ca = __expf(M[jj] - Mn), cb = __expf(m - Mn);
          Lsum[jj] = Lsum[jj] * ca + l * cb;
          A[jj].x = A[jj].x * ca + a[jj][u].x * cb;
          A[jj].y = A[jj].y * ca + a[jj][u].y * cb;
          A[jj].z = A[jj].z * ca + a[jj][u].z * cb;
          A[jj].w = A[jj].w * ca + a[jj][u].w * cb;
          M[jj] = Mn;
        }
      }
    }
  }
  T* o = out + ((size_t)b * Hkv + h) * G * D;
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    const int j = tid + jj * kThreads;
    if (j < V4) {
      const float den = fmaxf(Lsum[jj], 1e-30f);
      o[4 * j] = from_f32<T>(A[jj].x / den);
      o[4 * j + 1] = from_f32<T>(A[jj].y / den);
      o[4 * j + 2] = from_f32<T>(A[jj].z / den);
      o[4 * j + 3] = from_f32<T>(A[jj].w / den);
    }
  }
  if (tid == 0) counters[(size_t)b * Hkv + h] = 0;  // zero for the next call
}

template <typename T, int D, int G, bool Quant, bool Paged>
cudaError_t launch(const Args& a) {
  using KV = std::conditional_t<Quant, int8_t, T>;
  constexpr int bytes = Smem<KV, D, G>::kBytes;
  const auto kernel = decode_kernel<T, D, G, Quant, Paged>;
  if (bytes > 48 * 1024) {  // above the default: raise the block's limit
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.tiles, a.Hkv, a.B), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      a.k_scale, a.v_scale, a.table, a.positions, static_cast<T*>(a.out), a.counters,
      a.partials, a.launch_count, a.S, a.split_rows, a.num_splits, rsqrtf((float)D));
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
          int* counters, float* partials, int* launch_count, int B, int S, int H, int Hkv,
          int D, int dtype, int split_rows, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || split_rows <= 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (counters == nullptr || partials == nullptr) return (int)cudaErrorInvalidValue;
  if (Quant && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (Paged && (table == nullptr || S % split_rows != 0))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(partials)) % 16)
    return (int)cudaErrorMisalignedAddress;  // 16-byte loads and copies
  const int num_splits = (S + split_rows - 1) / split_rows;
  const Args a{q, k, v, k_scale, v_scale, table, positions, out, counters, partials,
               launch_count, B, S, Hkv, split_rows, num_splits,
               num_splits * ((split_rows + kTileRows - 1) / kTileRows),
               static_cast<cudaStream_t>(stream)};
  const int G = H / Hkv;
  if (dtype == 0) return (int)dispatch_d<float, Quant, Paged>(D, G, a);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16, Quant, Paged>(D, G, a);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block at (D, G, dtype), in bytes; -1 for a
// shape the kernel does not take.
template <typename KV, int D>
int smem_g(int G) {
  switch (G) {
    case 1: return Smem<KV, D, 1>::kBytes;
    case 2: return Smem<KV, D, 2>::kBytes;
    case 4: return Smem<KV, D, 4>::kBytes;
    case 8: return Smem<KV, D, 8>::kBytes;
    default: return -1;
  }
}

template <typename KV>
int smem_d(int D, int G) {
  switch (D) {
    case 16: return smem_g<KV, 16>(G);
    case 64: return smem_g<KV, 64>(G);
    case 128: return smem_g<KV, 128>(G);
    default: return -1;
  }
}

template <bool Quant>
int smem_bytes(int D, int G, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  if (Quant) return smem_d<int8_t>(D, G);
  return dtype == 0 ? smem_d<float>(D, G) : smem_d<__nv_bfloat16>(D, G);
}

}  // namespace omnia_decode

// Every edition exports one function of this signature (pointers into
// contiguous device tensors; unused ones may be null):
//   q [B, H, D] and k, v rows, 16-byte aligned; k_scale, v_scale; table
//   int32 [B, S/split_rows]; positions int32 [B]; out [B, H, D];
//   counters int32 [B * Hkv], zero on entry and on return; partials f32,
//   16-byte aligned, (D + 2) * G floats for each of B * Hkv * tiles, with
//   tiles = ceil(S / split_rows) * ceil(split_rows / 64); launch_count
//   int32, or null: a non-null count gets one added by the launch.
// Each also exports <entry>_smem_bytes(D, G, dtype): its block's dynamic
// shared memory (smem_bytes above), for reports.
#define OMNIA_DECODE_ARGS                                                        \
  const void *q, const void *k, const void *v, const float *k_scale,             \
      const float *v_scale, const int *table, const int *positions, void *out,   \
      int *counters, float *partials, int *launch_count, int B, int S, int H,    \
      int Hkv, int D, int dtype, int split_rows, void *stream
#define OMNIA_DECODE_CALL                                                        \
  q, k, v, k_scale, v_scale, table, positions, out, counters, partials,         \
      launch_count, B, S, H, Hkv, D, dtype, split_rows, stream

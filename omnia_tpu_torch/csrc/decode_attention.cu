// K1: GQA decode attention over a slot-contiguous float KV cache (q, k, v in
// one dtype), for Hopper (sm_90a).
//
// Replaces: omnia_tpu/ops/decode_attention.py, _decode_kernel with
// quantized=False, reached through decode_gqa_attention.
// The kernels, what bounds them and what their design does about it are
// in decode_attention.cuh; this file instantiates one edition of them.

#include "decode_attention.cuh"

extern "C" int omnia_decode_gqa_attention(OMNIA_DECODE_ARGS) {
  return omnia_decode::entry<false, false>(OMNIA_DECODE_CALL);
}

extern "C" int omnia_decode_gqa_attention_smem_bytes(int D, int G, int dtype) {
  return omnia_decode::smem_bytes<false>(D, G, dtype);
}

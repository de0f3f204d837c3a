// K2: GQA decode attention over a slot-contiguous int8 KV cache with f32 row
// scales [B, S, Hkv], for Hopper (sm_90a).
//
// Replaces: omnia_tpu/ops/decode_attention.py, _decode_kernel with
// quantized=True, reached through decode_gqa_attention with k_scale/v_scale.
// The kernels, what bounds them and what their design does about it are
// in decode_attention.cuh; this file instantiates one edition of them.

#include "decode_attention.cuh"

extern "C" int omnia_decode_gqa_attention_int8(OMNIA_DECODE_ARGS) {
  return omnia_decode::entry<true, false>(OMNIA_DECODE_CALL);
}

extern "C" int omnia_decode_gqa_attention_int8_smem_bytes(int D, int G, int dtype) {
  return omnia_decode::smem_bytes<true>(D, G, dtype);
}

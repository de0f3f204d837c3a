// K4: GQA decode attention over a paged int8 KV cache (pool [P, PAGE_S, Hkv,
// D] with f32 scale pools [P, PAGE_S, Hkv], addressed through a page table
// [B, NP]), for Hopper (sm_90a).
//
// Replaces: omnia_tpu/ops/decode_attention.py, _decode_kernel_paged with
// quantized=True, reached through decode_gqa_attention_paged with
// k_scale/v_scale.
// The kernels, what bounds them and what their design does about it are
// in decode_attention.cuh; this file instantiates one edition of them.

#include "decode_attention.cuh"

extern "C" int omnia_decode_gqa_attention_paged_int8(OMNIA_DECODE_ARGS) {
  return omnia_decode::entry<true, true>(OMNIA_DECODE_CALL);
}

extern "C" int omnia_decode_gqa_attention_paged_int8_smem_bytes(int D, int G, int dtype) {
  return omnia_decode::smem_bytes<true>(D, G, dtype);
}

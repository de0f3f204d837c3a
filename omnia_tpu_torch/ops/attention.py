"""Grouped-query attention over the serving KV cache (port of
``omnia_tpu/ops/attention.py::gqa_attention``).

Cache row ``s`` holds position ``s`` of its sequence, so the causal mask
is ``key_idx <= q_position``. GQA reshapes q to [B, T, Hkv, G, D] and
never repeats K/V; scores and softmax are f32. The cache is a plain
tensor, a ``QuantKV`` (int8 rows + f32 row scales: the k scale
multiplies the scores, the v scale folds into the probabilities, the
cache is never dequantized as a whole) or a ``PagedKV`` of either.

A decode step (T == 1) on a CUDA tensor runs the hand-written kernel of
``ops/decode_attention.py`` of the cache's edition (K1–K4), whose
traffic follows each slot's real context; every other call runs the
plain path below, a paged cache through its slot-contiguous view.
"""

from __future__ import annotations

import torch

from omnia_tpu_torch.models.kv_quant import is_quant_kv
from omnia_tpu_torch.models.paged_kv import gather_view, is_paged
from omnia_tpu_torch.ops.decode_attention import (
    decode_gqa_attention,
    decode_gqa_attention_paged,
)

_NEG_INF = -1e30


def _rows_and_scales(cache):
    if is_quant_kv(cache):
        return cache.q, cache.s
    return cache, None


def _decode_kernel(q, k_cache, v_cache, q_positions):
    """T == 1 on the card: the kernel of the cache's edition."""
    q1 = q[:, 0].contiguous()
    pos = q_positions[:, 0].to(torch.int32).contiguous()
    if is_paged(k_cache):
        pk, ks = _rows_and_scales(k_cache.pool)
        pv, vs = _rows_and_scales(v_cache.pool)
        out = decode_gqa_attention_paged(q1, pk, pv, k_cache.table, pos,
                                         k_scale=ks, v_scale=vs)
    else:
        k, ks = _rows_and_scales(k_cache)
        v, vs = _rows_and_scales(v_cache)
        out = decode_gqa_attention(q1, k, v, pos, k_scale=ks, v_scale=vs)
    return out[:, None]


def gqa_attention(q: torch.Tensor, k_cache, v_cache,
                  q_positions: torch.Tensor) -> torch.Tensor:
    """q [B, T, H, D] (rotary applied); k_cache, v_cache [B, S, Hkv, D]
    (tensor, QuantKV or PagedKV); q_positions int [B, T] → [B, T, H, D]."""
    B, T, H, D = q.shape
    if T == 1 and q.device.type == "cuda":
        return _decode_kernel(q, k_cache, v_cache, q_positions)

    if is_paged(k_cache):
        k_cache = gather_view(k_cache)
        v_cache = gather_view(v_cache)
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    if is_quant_kv(k_cache):
        # The k scale factors out of the D contraction onto the scores.
        scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_cache.q.float())
        scores = scores * k_cache.s.permute(0, 2, 1)[:, :, None, None, :]
    else:
        scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_cache.float())
    scores = scores * (D ** -0.5)
    key_idx = torch.arange(S, device=q.device)
    mask = key_idx[None, None, :] <= q_positions[:, :, None]      # [B, T, S]
    scores = torch.where(mask[:, None, None], scores, _NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if is_quant_kv(v_cache):
        # The v scale varies along the contracted S axis: it folds into
        # the probabilities before the pv product.
        v_s = v_cache.s.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bhgts,bshd->bthgd", probs * v_s, v_cache.q.float())
        out = out.to(q.dtype)
    else:
        out = torch.einsum("bhgts,bshd->bthgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, T, H, D)

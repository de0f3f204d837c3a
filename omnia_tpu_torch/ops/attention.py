"""Grouped-query attention over a slot-contiguous KV cache (port of
``omnia_tpu/ops/attention.py::gqa_attention``, contiguous unquantized).

Cache row ``s`` holds position ``s`` of its sequence, so the causal mask
is ``key_idx <= q_position``. GQA reshapes q to [B, T, Hkv, G, D] and
never repeats K/V; scores and softmax are f32.

A decode step (T == 1) on a CUDA tensor runs the hand-written kernel of
``ops/decode_attention.py``, whose traffic follows each slot's real
context; every other call runs the plain path below.
"""

from __future__ import annotations

import torch

from omnia_tpu_torch.ops.decode_attention import decode_gqa_attention

_NEG_INF = -1e30


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  q_positions: torch.Tensor) -> torch.Tensor:
    """q [B, T, H, D] (rotary applied); k_cache, v_cache [B, S, Hkv, D];
    q_positions int [B, T] → [B, T, H, D]."""
    B, T, H, D = q.shape
    if T == 1 and q.device.type == "cuda":
        out = decode_gqa_attention(
            q[:, 0].contiguous(), k_cache, v_cache,
            q_positions[:, 0].to(torch.int32).contiguous(),
        )
        return out[:, None]

    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k_cache.float())
    scores = scores * (D ** -0.5)
    key_idx = torch.arange(S, device=q.device)
    mask = key_idx[None, None, :] <= q_positions[:, :, None]      # [B, T, S]
    scores = torch.where(mask[:, None, None], scores, _NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, T, H, D)

"""Ring attention: causal sequence parallelism over the "sp" axis (port of
``omnia_tpu/parallel/ring_attention.py``).

Each rank of the ring holds one contiguous block of ``T / sp`` rows of
the queries, keys and values. At each of ``sp`` steps a rank folds the
K/V block it holds into running softmax accumulators (the maximum ``m``,
the normalizer ``l`` and the unnormalized output ``o``, all f32), then
hands the block to the next rank of the ring (``Comm.shift``, the
``ppermute`` of the JAX package). Step 0 is the rank's own block, so
every query row meets its diagonal first; causality across blocks comes
from global row positions, and a block wholly in a row's future still
costs one fully masked block update, as in the reference.

The block update is plain torch, as the reference's is plain ``jnp``
(it reaches no Pallas kernel): scores from f32 products (bf16 operands
products are exact in f32, as ``preferred_element_type=f32`` gives), the
probabilities cast to the value dtype for the output product.
``dense_attention`` is the plain single-rank reference the tests hold
the ring against.
"""

from __future__ import annotations

from typing import Optional

import torch

from omnia_tpu_torch.parallel.collectives import Comm

_NEG_INF = -1e30


def _block_update(q, k, v, q_pos, k_pos, m, l, o):
    """Fold one K/V block into the running (m, l, o) accumulators.

    q: [B, Tq, Hkv, G, D] (grouped queries); k, v: [B, Tk, Hkv, D];
    q_pos, k_pos: int [Tq], [Tk] global positions; m, l: [B, Hkv, G, Tq]
    f32; o: [B, Tq, Hkv, G, D] f32."""
    D = q.shape[-1]
    scores = torch.einsum("bthgd,bshd->bhgts", q.float(), k.float()) * (D ** -0.5)
    mask = k_pos[None, :] <= q_pos[:, None]                          # [Tq, Tk] causal
    scores = torch.where(mask, scores, _NEG_INF)
    new_m = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - new_m)                                     # rescale the old
    p = torch.exp(scores - new_m[..., None])
    new_l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype), v).float()
    new_o = o * alpha.movedim(-1, 1)[..., None] + pv
    return new_m, new_l, new_o


def ring_attention(q, k, v, sp: Optional[Comm] = None):
    """Causal attention of this rank's block of rows over every rank's
    keys. q: [B, Tl, H, D]; k, v: [B, Tl, Hkv, D], rows ``[i * Tl, (i +
    1) * Tl)`` of the sequence on ring rank i. Returns [B, Tl, H, D] in
    q's dtype. With ``sp=None`` the ring is this rank alone: causal
    attention over its own rows."""
    B, Tl, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    n = 1 if sp is None else sp.size
    i = 0 if sp is None else sp.index
    qg = q.reshape(B, Tl, Hkv, G, D)
    offs = torch.arange(Tl, dtype=torch.int32, device=q.device)
    q_pos = i * Tl + offs
    m = torch.full((B, Hkv, G, Tl), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Tl), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Tl, Hkv, G, D), dtype=torch.float32, device=q.device)
    kj, vj = k, v
    for j in range(n):
        src = (i - j) % n            # whose block this rank holds at step j
        m, l, o = _block_update(qg, kj, vj, q_pos, src * Tl + offs, m, l, o)
        if j + 1 < n:
            # The last step's shift would only bring back this rank's own
            # block: skipped.
            kj, vj = sp.shift(kj), sp.shift(vj)
    # The diagonal block gives every causal row l > 0.
    out = o / l.movedim(-1, 1)[..., None]
    return out.reshape(B, Tl, H, D).to(q.dtype)


def dense_attention(q, k, v):
    """The plain reference: causal GQA over the whole sequence on one rank
    (q [B, T, H, D], k, v [B, T, Hkv, D], positions 0..T-1), f32 softmax."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), kk) * (D ** -0.5)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(torch.where(causal, scores, _NEG_INF), dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, vv).to(q.dtype)

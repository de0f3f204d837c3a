"""Llama-family transformer in PyTorch, dense MLP or Mixtral-style MoE
(port of ``omnia_tpu/models/llama.py``).

- **Params keep the JAX layout**: a plain dict with every layer stacked
  on a leading [L] axis and projections stored [in, out], so converting
  a JAX tree (``models/convert.py``) is a plain copy.
- **One forward for prefill and decode.** The KV cache is slot-contiguous
  ``[L, B, S, Hkv, D]`` (row s = position s), int8 (``QuantKV``, rows
  quantized on write) or paged (``PagedKV``: a page pool ``[L, P,
  PAGE_S, Hkv, D]`` and one page table shared by its layers); each step
  writes its rows in place at per-slot ``write_start`` and causality is
  ``key_index <= query_position`` (``ops/attention.py``).
- **Cache-free forwards**: ``forward_train`` (logits, differentiable)
  and ``forward_embed`` (the embedding role's pooled vectors) run the
  same layer over the chunk's own keys at positions 0..T-1.
- Compute dtype is the params' dtype; logits and softmax statistics f32.
- **int8 weights**: every projection goes through ``quant.qdot``, so a
  quantized tree (``models/quant.py``) serves with no other change; the
  embedding gather and the tied-embedding logits stay full precision.

- **MoE** (``cfg.num_experts > 0``): the MLP is ``ops/moe.py::moe_mlp``,
  all experts below 64 rows of a forward (B·T) and capacity dispatch
  from 64 on, so a program gives the JAX package's tokens when it calls
  the forward with the JAX program's (B, T) and pad rows. The router
  ``[L, D, E]`` and the experts ``[L, E, D, F]`` / ``[L, E, F, D]`` stay
  full precision under int8 weights, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from omnia_tpu_torch.models.config import ModelConfig
from omnia_tpu_torch.models.kv_quant import (
    QuantKV,
    is_quant_kv,
    kv_map,
    quantize_rows,
    validate_kv_quant,
)
from omnia_tpu_torch.models.paged_kv import PagedKV, flat_rows, is_paged, scatter_rows
from omnia_tpu_torch.models.quant import qdot
from omnia_tpu_torch.ops.attention import gqa_attention
from omnia_tpu_torch.ops.moe import moe_mlp
from omnia_tpu_torch.ops.norms import rms_norm
from omnia_tpu_torch.ops.rope import apply_rope, rope_cos_sin


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random-initialized params (layers stacked on axis 0), drawn tensor
    by tensor directly in ``dtype`` on ``device`` (the generator's device),
    so no f32 copy of the model ever exists. Same shapes and stds as the
    JAX package; not the same numbers."""
    L, D, F_, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return t.mul_(std)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    out_std = 0.02 / (2 * L) ** 0.5
    if cfg.is_moe:
        E = cfg.num_experts
        mlp = {
            "router": normal((L, D, E)),
            "wg": normal((L, E, D, F_)),
            "wu": normal((L, E, D, F_)),
            "wd": normal((L, E, F_, D), std=out_std),
        }
    else:
        mlp = {
            "wg": normal((L, D, F_)),
            "wu": normal((L, D, F_)),
            "wd": normal((L, F_, D), std=out_std),
        }
    params = {
        "embed": normal((V, D)),
        "layers": {
            "ln1": ones((L, D)),
            "ln2": ones((L, D)),
            "attn": {
                "wq": normal((L, D, cfg.q_dim)),
                "wk": normal((L, D, cfg.kv_dim)),
                "wv": normal((L, D, cfg.kv_dim)),
                "wo": normal((L, cfg.q_dim, D), std=out_std),
            },
            "mlp": mlp,
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V))
    return params


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, device,
                  dtype: torch.dtype = torch.bfloat16, kv_quant=None):
    """Zeroed (k, v) caches: [L, B, S, Hkv, D] tensors, or QuantKV pairs
    (int8 rows + [L, B, S, Hkv] f32 scales) when kv_quant is set. A page
    pool is the same allocation with B pages of S rows."""
    shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
    if validate_kv_quant(kv_quant):
        def one():
            return QuantKV(torch.zeros(shape, device=device, dtype=torch.int8),
                           torch.zeros(shape[:-1], device=device, dtype=torch.float32))

        return one(), one()
    return (torch.zeros(shape, device=device, dtype=dtype),
            torch.zeros(shape, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _dense_mlp(h, p):
    gate = qdot(h, p["wg"])
    up = qdot(h, p["wu"])
    return qdot(F.silu(gate) * up, p["wd"])


def _moe_mlp(h, p, cfg: ModelConfig):
    """Mixtral MoE: routing and dispatch live in ops/moe.py; decode-sized
    forwards take the all-expert path, prefill-sized ones capacity
    dispatch."""
    return moe_mlp(h, p, cfg.num_experts_per_tok)


def _write_index(cache, start: torch.Tensor, T: int):
    """Where a forward's [B, T] rows land in an engine-level cache: the
    same for every layer and for k and v, so computed once per forward.
    Contiguous: (batch, rows) into [B, S], the start clamped so the T
    rows fit, like ``dynamic_update_slice``. Paged: rows of the
    flattened pool (``paged_kv.flat_rows``)."""
    if is_paged(cache):
        return flat_rows(cache.table, cache.page_tokens, start, T)
    S = cache.shape[2]
    start = start.to(torch.long).clamp(0, S - T)
    rows = start[:, None] + torch.arange(T, device=start.device)[None, :]
    batch = torch.arange(start.shape[0], device=start.device)[:, None]
    return batch, rows


def _write_kv(cache, new: torch.Tensor, index) -> None:
    """One layer's cache [B, S, Hkv, D] ← new [B, T, Hkv, D] at
    ``index`` (``_write_index``), in place. A QuantKV cache quantizes the
    new rows here; a PagedKV cache writes them through its table."""
    if is_paged(cache):
        scatter_rows(cache.pool, index, new)
    elif is_quant_kv(cache):
        qn = quantize_rows(new)
        cache.q[index] = qn.q
        cache.s[index] = qn.s
    else:
        cache[index] = new.to(cache.dtype)


def _unbind(tree) -> list:
    """A tree of stacked [L, ...] leaves as L trees of views (``[L, E, D,
    F]`` experts are read in place; a quantized leaf member by member)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        return [dict(zip(parts, layer)) for layer in zip(*parts.values())]
    return tree.unbind(0)


def _layers(params: dict) -> list[dict]:
    """Every layer's params, one unbind per stacked leaf. Under autograd
    a leaf's gradient is then one stack of its layers' gradients, where
    taking layer i by indexing adds L zero-padded full-size gradients."""
    return _unbind(params["layers"])


def _layer(x, p, cfg: ModelConfig, cos, sin, q_positions, ck, cv, write_index):
    """One layer. With ck/cv None the attention is over the chunk's own
    keys (fresh prefill) and the chunk's (k, v) is returned; otherwise
    the rows are written into ck/cv in place and attention reads them."""
    B, T, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    q = qdot(h, p["attn"]["wq"]).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = qdot(h, p["attn"]["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = qdot(h, p["attn"]["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if ck is None:
        ck_eff, cv_eff = k, v
    else:
        _write_kv(ck, k, write_index)
        _write_kv(cv, v, write_index)
        ck_eff, cv_eff = ck, cv
    attn = gqa_attention(q, ck_eff, cv_eff, q_positions)
    x = x + qdot(attn.reshape(B, T, -1), p["attn"]["wo"])
    h2 = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    if cfg.is_moe:
        x = x + _moe_mlp(h2, p["mlp"], cfg)
    else:
        x = x + _dense_mlp(h2, p["mlp"])
    return x, k, v


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T).float()
    return qdot(x, params["lm_head"]).float()


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward_prefill(params, cfg: ModelConfig, tokens, q_positions):
    """Fresh-sequence prefill: attention over the chunk itself.

    tokens, q_positions: int [B, T] → (logits [B, T, V] f32,
    k_chunk, v_chunk [L, B, T, Hkv, D]) for the engine to place."""
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    ks, vs = [], []
    for p in _layers(params):
        x, k, v = _layer(x, p, cfg, cos, sin, q_positions, None, None, None)
        ks.append(k)
        vs.append(v)
    return _logits(params, cfg, x), torch.stack(ks), torch.stack(vs)


def _layer_cache(cache, i: int):
    """Layer i of an engine-level cache (views: writes land in place)."""
    if is_paged(cache):
        # One page holds a row of every layer: the table is shared.
        return PagedKV(kv_map(lambda a: a[i], cache.pool), cache.table)
    return kv_map(lambda a: a[i], cache)


def forward(params, cfg: ModelConfig, tokens, q_positions, cache_k, cache_v,
            write_start: Optional[torch.Tensor]):
    """Serving forward (prefill or decode: same code, different T).

    tokens, q_positions: int [B, T]; cache_k/v: [L, B, S, Hkv, D]
    tensors, QuantKV or PagedKV; write_start: int [B] row where this
    chunk's KV lands. The caches are updated IN PLACE (JAX returns new
    arrays; here the cache is the one allocation) and returned for
    symmetry with the JAX signature.
    Returns (logits [B, T, V] f32, cache_k, cache_v)."""
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    index = _write_index(cache_k, write_start, tokens.shape[1])
    for i, p in enumerate(_layers(params)):
        x, _, _ = _layer(x, p, cfg, cos, sin, q_positions,
                         _layer_cache(cache_k, i), _layer_cache(cache_v, i), index)
    return _logits(params, cfg, x), cache_k, cache_v


def _hidden(params, cfg: ModelConfig, tokens):
    """The cache-free causal forward at positions 0..T-1: tokens int [B,
    T] → the last layer's output [B, T, D], before the final norm."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    q_positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    for p in _layers(params):
        x, _, _ = _layer(x, p, cfg, cos, sin, q_positions, None, None, None)
    return x


def forward_embed(params, cfg: ModelConfig, tokens, mask):
    """Embedding-role forward: the masked mean-pool of the final normed
    hidden states, L2-normalized, f32 [B, D].

    tokens: int [B, T]; mask: [B, T] (1 = real token, 0 = pad). A row
    with no real token pools to zeros."""
    x = rms_norm(_hidden(params, cfg, tokens), params["final_norm"],
                 cfg.rms_norm_eps).float()
    m = mask.float()[:, :, None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


def forward_train(params, cfg: ModelConfig, tokens):
    """Full causal forward with no cache (training and scoring): tokens
    int [B, T] → logits [B, T, V] f32. Differentiable for T > 1; a T == 1
    call on the card runs the decode kernel, which has no backward and
    refuses inputs that need a gradient."""
    return _logits(params, cfg, _hidden(params, cfg, tokens))

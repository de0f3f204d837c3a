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

- **Tensor parallelism** (``tp``, a :class:`~omnia_tpu_torch.parallel.Comm`
  of the mesh's "tp" axis): ``param_specs`` splits heads, FFN, experts
  and vocab as the JAX package's does; each rank holds its slice and
  runs the same forward with the collectives GSPMD inserts there made
  explicit: a SUM after ``wo`` and ``wd`` (and the experts' combine), a
  MAX of W8A8's activation amax before those two, and a SUM after the
  vocab-parallel embedding lookup. Head counts come from the local
  weights' shapes. Under tp the forwards return this rank's vocab slice
  of the logits; ``gather_logits`` joins what a sampler reads. With
  ``tp=None`` no collective runs.
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
from omnia_tpu_torch.models.quant import is_quantized, qdot
from omnia_tpu_torch.ops.attention import gqa_attention
from omnia_tpu_torch.ops.moe import moe_mlp
from omnia_tpu_torch.ops.norms import rms_norm
from omnia_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from omnia_tpu_torch.parallel.collectives import Comm, all_gather, all_reduce_sum
from omnia_tpu_torch.parallel.sharding import P, shard_leaf


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: torch.dtype = torch.bfloat16, mesh=None) -> dict:
    """Random-initialized params (layers stacked on axis 0), drawn tensor
    by tensor directly in ``dtype`` on ``device`` (the generator's device),
    so no f32 copy of the model ever exists. Same shapes and stds as the
    JAX package; not the same numbers. With a ``mesh`` each leaf is cut to
    this rank's slice (``param_specs``) as soon as it is drawn: the
    values are the unsharded tree's, and one whole leaf at most exists."""
    L, D, F_, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size
    specs = param_specs(cfg)

    def normal(shape, spec, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        t.mul_(std)
        return t if mesh is None else shard_leaf(t, spec, mesh)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    out_std = 0.02 / (2 * L) ** 0.5
    sa, sm = specs["layers"]["attn"], specs["layers"]["mlp"]
    if cfg.is_moe:
        E = cfg.num_experts
        mlp = {
            "router": normal((L, D, E), sm["router"]),
            "wg": normal((L, E, D, F_), sm["wg"]),
            "wu": normal((L, E, D, F_), sm["wu"]),
            "wd": normal((L, E, F_, D), sm["wd"], std=out_std),
        }
    else:
        mlp = {
            "wg": normal((L, D, F_), sm["wg"]),
            "wu": normal((L, D, F_), sm["wu"]),
            "wd": normal((L, F_, D), sm["wd"], std=out_std),
        }
    params = {
        "embed": normal((V, D), specs["embed"]),
        "layers": {
            "ln1": ones((L, D)),
            "ln2": ones((L, D)),
            "attn": {
                "wq": normal((L, D, cfg.q_dim), sa["wq"]),
                "wk": normal((L, D, cfg.kv_dim), sa["wk"]),
                "wv": normal((L, D, cfg.kv_dim), sa["wv"]),
                "wo": normal((L, cfg.q_dim, D), sa["wo"], std=out_std),
            },
            "mlp": mlp,
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), specs["lm_head"])
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The spec tree of ``init_params`` (the JAX package's, megatron-style
    over "tp"): q, k, v column-parallel over heads, ``wo`` row-parallel;
    ``wg``/``wu`` column-parallel over the FFN, ``wd`` row-parallel; MoE
    experts split over "tp" with the router replicated; ``embed`` split
    over the vocabulary and ``lm_head`` column-parallel over it."""
    attn = {
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
    }
    if cfg.is_moe:
        mlp = {
            "router": P(None, None, None),
            "wg": P(None, "tp", None, None),
            "wu": P(None, "tp", None, None),
            "wd": P(None, "tp", None, None),
        }
    else:
        mlp = {
            "wg": P(None, None, "tp"),
            "wu": P(None, None, "tp"),
            "wd": P(None, "tp", None),
        }
    specs = {
        "embed": P("tp", None),
        "layers": {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "attn": attn,
            "mlp": mlp,
        },
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "tp")
    return specs


def kv_cache_specs(kv_quant=None) -> tuple:
    """(k, v) specs of ``[L, B, S, Hkv, D]`` caches: batch over "dp", KV
    heads over "tp". With kv_quant the tree mirrors QuantKV (the scales
    drop the head-dim axis and keep the head axis)."""
    spec = P(None, "dp", None, "tp", None)
    if validate_kv_quant(kv_quant):
        qspec = QuantKV(spec, P(None, "dp", None, "tp"))
        return qspec, qspec
    return spec, spec


def paged_kv_specs(kv_quant=None) -> tuple:
    """(k, v) specs of PagedKV caches: the pool's page axis over "dp", KV
    heads over "tp"; the page table replicated."""
    kspec, vspec = kv_cache_specs(kv_quant)
    tspec = P(None, None)
    return PagedKV(kspec, tspec), PagedKV(vspec, tspec)


def _q_columns(params: dict) -> int:
    """The query projection's output columns this tree holds."""
    wq = params["layers"]["attn"]["wq"]
    return (wq["s"] if is_quantized(wq) else wq).shape[-1]


def params_sharded(params: dict, cfg: ModelConfig, tp: int) -> bool:
    """Whether ``params`` already holds one rank's slice at ``tp`` (wq's
    output width is ``q_dim / tp``) rather than the whole tree."""
    return tp > 1 and _q_columns(params) * tp == cfg.q_dim


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, device,
                  dtype: torch.dtype = torch.bfloat16, kv_quant=None, tp: int = 1):
    """Zeroed (k, v) caches: [L, B, S, Hkv / tp, D] tensors (one rank's
    KV heads), or QuantKV pairs (int8 rows + [L, B, S, Hkv / tp] f32
    scales) when kv_quant is set. A page pool is the same allocation
    with B pages of S rows."""
    shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads // tp, cfg.head_dim)
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


def _dense_mlp(h, p, tp: Optional[Comm]):
    gate = qdot(h, p["wg"])
    up = qdot(h, p["wu"])
    return qdot(F.silu(gate) * up, p["wd"], tp)


def _moe_mlp(h, p, cfg: ModelConfig, tp: Optional[Comm]):
    """Mixtral MoE: routing and dispatch live in ops/moe.py; decode-sized
    forwards take the all-expert path, prefill-sized ones capacity
    dispatch."""
    return moe_mlp(h, p, cfg.num_experts_per_tok, comm=tp)


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


def _layer(x, p, cfg: ModelConfig, cos, sin, q_positions, ck, cv, write_index,
           tp: Optional[Comm] = None):
    """One layer. With ck/cv None the attention is over the chunk's own
    keys (fresh prefill) and the chunk's (k, v) is returned; otherwise
    the rows are written into ck/cv in place and attention reads them.
    The head counts are the local weights' (this rank's heads under tp)."""
    B, T, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    q = qdot(h, p["attn"]["wq"]).reshape(B, T, -1, cfg.head_dim)
    k = qdot(h, p["attn"]["wk"]).reshape(B, T, -1, cfg.head_dim)
    v = qdot(h, p["attn"]["wv"]).reshape(B, T, -1, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if ck is None:
        ck_eff, cv_eff = k, v
    else:
        _write_kv(ck, k, write_index)
        _write_kv(cv, v, write_index)
        ck_eff, cv_eff = ck, cv
    attn = gqa_attention(q, ck_eff, cv_eff, q_positions)
    x = x + qdot(attn.reshape(B, T, -1), p["attn"]["wo"], tp)
    h2 = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    if cfg.is_moe:
        x = x + _moe_mlp(h2, p["mlp"], cfg, tp)
    else:
        x = x + _dense_mlp(h2, p["mlp"], tp)
    return x, k, v


def _check_tp(params, cfg: ModelConfig, tp: Optional[Comm]) -> None:
    """Refuse a tree whose slicing disagrees with ``tp``: a whole tree
    under tp would be summed tp times over."""
    n = 1 if tp is None else tp.size
    if _q_columns(params) * n != cfg.q_dim:
        raise ValueError(f"params hold {_q_columns(params)} of {cfg.q_dim} query columns, "
                         f"not a tp={n} slice")


def _embed(params, cfg: ModelConfig, tokens, tp: Optional[Comm]):
    """The embedding lookup; under tp vocab-parallel: each rank looks up
    the ids in its vocab slice (zero rows elsewhere) and the SUM over
    ranks gives every row once."""
    table = params["embed"]
    if tp is None:
        return table[tokens]
    V = table.shape[0]
    local = tokens.long() - tp.index * V
    inside = (local >= 0) & (local < V)
    rows = table[local.clamp(0, V - 1)] * inside[..., None].to(table.dtype)
    return all_reduce_sum(rows, tp)


def _logits(params, cfg: ModelConfig, x):
    """f32 logits over the local vocabulary: all of it, or this rank's
    slice under tp (``gather_logits`` joins them)."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T).float()
    return qdot(x, params["lm_head"]).float()


def gather_logits(logits, tp: Optional[Comm]):
    """The whole vocabulary's logits from each rank's slice (the logits
    a sampler reads; identical bytes on every rank). With ``tp=None`` the
    logits themselves."""
    return all_gather(logits, tp, dim=-1)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward_prefill(params, cfg: ModelConfig, tokens, q_positions,
                    tp: Optional[Comm] = None):
    """Fresh-sequence prefill: attention over the chunk itself.

    tokens, q_positions: int [B, T] → (logits [B, T, V] f32 (this rank's
    vocab slice under tp), k_chunk, v_chunk [L, B, T, Hkv, D]) for the
    engine to place."""
    _check_tp(params, cfg, tp)
    x = _embed(params, cfg, tokens, tp)
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    ks, vs = [], []
    for p in _layers(params):
        x, k, v = _layer(x, p, cfg, cos, sin, q_positions, None, None, None, tp)
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
            write_start: Optional[torch.Tensor], tp: Optional[Comm] = None):
    """Serving forward (prefill or decode: same code, different T).

    tokens, q_positions: int [B, T]; cache_k/v: [L, B, S, Hkv, D]
    tensors, QuantKV or PagedKV; write_start: int [B] row where this
    chunk's KV lands. The caches are updated IN PLACE (JAX returns new
    arrays; here the cache is the one allocation) and returned for
    symmetry with the JAX signature.
    Returns (logits [B, T, V] f32 (this rank's vocab slice under tp),
    cache_k, cache_v)."""
    _check_tp(params, cfg, tp)
    x = _embed(params, cfg, tokens, tp)
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    index = _write_index(cache_k, write_start, tokens.shape[1])
    for i, p in enumerate(_layers(params)):
        x, _, _ = _layer(x, p, cfg, cos, sin, q_positions,
                         _layer_cache(cache_k, i), _layer_cache(cache_v, i), index, tp)
    return _logits(params, cfg, x), cache_k, cache_v


def _hidden(params, cfg: ModelConfig, tokens, tp: Optional[Comm] = None):
    """The cache-free causal forward at positions 0..T-1: tokens int [B,
    T] → the last layer's output [B, T, D], before the final norm."""
    _check_tp(params, cfg, tp)
    B, T = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    q_positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    for p in _layers(params):
        x, _, _ = _layer(x, p, cfg, cos, sin, q_positions, None, None, None, tp)
    return x


def forward_embed(params, cfg: ModelConfig, tokens, mask, tp: Optional[Comm] = None):
    """Embedding-role forward: the masked mean-pool of the final normed
    hidden states, L2-normalized, f32 [B, D].

    tokens: int [B, T]; mask: [B, T] (1 = real token, 0 = pad). A row
    with no real token pools to zeros."""
    x = rms_norm(_hidden(params, cfg, tokens, tp), params["final_norm"],
                 cfg.rms_norm_eps).float()
    m = mask.float()[:, :, None]
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-9)


def forward_train(params, cfg: ModelConfig, tokens, tp: Optional[Comm] = None):
    """Full causal forward with no cache (training and scoring): tokens
    int [B, T] → logits [B, T, V] f32, the whole vocabulary on every rank
    under tp. Differentiable for T > 1 without tp; a T == 1 call on the
    card runs the decode kernel, which has no backward and refuses inputs
    that need a gradient."""
    return gather_logits(_logits(params, cfg, _hidden(params, cfg, tokens, tp)), tp)

"""Llama-family dense transformer in PyTorch (port of the dense path of
``omnia_tpu/models/llama.py``).

- **Params keep the JAX layout**: a plain dict with every layer stacked
  on a leading [L] axis and projections stored [in, out], so converting
  a JAX tree (``models/convert.py``) is a plain copy.
- **One forward for prefill and decode.** The KV cache is slot-contiguous
  ``[L, B, S, Hkv, D]`` (row s = position s); each step writes its rows
  in place at per-slot ``write_start`` and causality is ``key_index <=
  query_position`` (``ops/attention.py``).
- Compute dtype is the params' dtype; logits and softmax statistics f32.

MoE, int8 weights and paged or int8 KV caches are not ported yet and
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from omnia_tpu_torch.models.config import ModelConfig
from omnia_tpu_torch.ops.attention import gqa_attention
from omnia_tpu_torch.ops.norms import rms_norm
from omnia_tpu_torch.ops.rope import apply_rope, rope_cos_sin


def _refuse_moe(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE is not ported yet (ROADMAP A12)"
        )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random-initialized params (layers stacked on axis 0), drawn tensor
    by tensor directly in ``dtype`` on ``device`` (the generator's device),
    so no f32 copy of the model ever exists. Same shapes and stds as the
    JAX package; not the same numbers."""
    _refuse_moe(cfg)
    L, D, F_, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden_size, cfg.vocab_size

    def normal(shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return t.mul_(std)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    out_std = 0.02 / (2 * L) ** 0.5
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
            "mlp": {
                "wg": normal((L, D, F_)),
                "wu": normal((L, D, F_)),
                "wd": normal((L, F_, D), std=out_std),
            },
        },
        "final_norm": ones((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V))
    return params


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, device,
                  dtype: torch.dtype = torch.bfloat16, kv_quant=None):
    """Zeroed (k, v) caches [L, B, S, Hkv, D]."""
    if kv_quant is not None:
        raise NotImplementedError("int8 KV cache is not ported yet (ROADMAP A8)")
    shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, device=device, dtype=dtype),
            torch.zeros(shape, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _dot(h: torch.Tensor, w) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            "int8 weights are not ported yet (ROADMAP A10)"
        )
    return torch.matmul(h, w)


def _dense_mlp(h, p):
    gate = _dot(h, p["wg"])
    up = _dot(h, p["wu"])
    return _dot(F.silu(gate) * up, p["wd"])


def _write_kv(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """cache [B, S, Hkv, D] ← new [B, T, Hkv, D] at per-slot rows
    start [B], in place. Like ``dynamic_update_slice`` the start is
    clamped so the T rows fit the cache."""
    B, T = new.shape[:2]
    S = cache.shape[1]
    start = start.to(torch.long).clamp(0, S - T)
    rows = start[:, None] + torch.arange(T, device=cache.device)[None, :]
    batch = torch.arange(B, device=cache.device)[:, None]
    cache[batch, rows] = new.to(cache.dtype)


def _layer_params(params: dict, i: int) -> dict:
    lp = params["layers"]
    return {
        "ln1": lp["ln1"][i],
        "ln2": lp["ln2"][i],
        "attn": {n: w[i] for n, w in lp["attn"].items()},
        "mlp": {n: w[i] for n, w in lp["mlp"].items()},
    }


def _layer(x, p, cfg: ModelConfig, cos, sin, q_positions, ck, cv, write_start):
    """One layer. With ck/cv None the attention is over the chunk's own
    keys (fresh prefill) and the chunk's (k, v) is returned; otherwise
    the rows are written into ck/cv in place and attention reads them."""
    B, T, _ = x.shape
    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    q = _dot(h, p["attn"]["wq"]).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = _dot(h, p["attn"]["wk"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = _dot(h, p["attn"]["wv"]).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if ck is None:
        ck_eff, cv_eff = k, v
    else:
        _write_kv(ck, k, write_start)
        _write_kv(cv, v, write_start)
        ck_eff, cv_eff = ck, cv
    attn = gqa_attention(q, ck_eff, cv_eff, q_positions)
    x = x + _dot(attn.reshape(B, T, -1), p["attn"]["wo"])
    h2 = rms_norm(x, p["ln2"], cfg.rms_norm_eps)
    x = x + _dense_mlp(h2, p["mlp"])
    return x, k, v


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T).float()
    return _dot(x, params["lm_head"]).float()


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def forward_prefill(params, cfg: ModelConfig, tokens, q_positions):
    """Fresh-sequence prefill: attention over the chunk itself.

    tokens, q_positions: int [B, T] → (logits [B, T, V] f32,
    k_chunk, v_chunk [L, B, T, Hkv, D]) for the engine to place."""
    _refuse_moe(cfg)
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v = _layer(x, _layer_params(params, i), cfg, cos, sin,
                         q_positions, None, None, None)
        ks.append(k)
        vs.append(v)
    return _logits(params, cfg, x), torch.stack(ks), torch.stack(vs)


def forward(params, cfg: ModelConfig, tokens, q_positions,
            cache_k: torch.Tensor, cache_v: torch.Tensor,
            write_start: Optional[torch.Tensor]):
    """Serving forward (prefill or decode: same code, different T).

    tokens, q_positions: int [B, T]; cache_k/v: [L, B, S, Hkv, D];
    write_start: int [B] row where this chunk's KV lands. The caches are
    updated IN PLACE (JAX returns new arrays; here the cache is the one
    allocation) and returned for symmetry with the JAX signature.
    Returns (logits [B, T, V] f32, cache_k, cache_v)."""
    _refuse_moe(cfg)
    if not (isinstance(cache_k, torch.Tensor) and isinstance(cache_v, torch.Tensor)):
        raise NotImplementedError(
            "paged / int8 KV caches are not ported yet (ROADMAP A8, A9)"
        )
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    for i in range(cfg.num_layers):
        x, _, _ = _layer(x, _layer_params(params, i), cfg, cos, sin,
                         q_positions, cache_k[i], cache_v[i], write_start)
    return _logits(params, cfg, x), cache_k, cache_v

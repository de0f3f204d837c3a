"""Vectorized token sampling: temperature / top-k / top-p / greedy (port
of ``omnia_tpu/ops/sampling.py``).

All knobs are per-row tensors, so one decode step serves a batch of
requests with different settings. top-k is applied first, then the
nucleus is taken over the renormalized top-k survivors (the HF/vLLM
convention). The threshold comes from the 256-entry descending prefix
when that is exact for every row, and otherwise from an exact full sort.
Both are computed and the batch picks one with ``torch.where`` on the
same predicate as the JAX package, so no step waits on the host.

Contract with the JAX package:

- greedy tokens (temperature <= 0) are identical: both take the first
  index of the maximum of the same f32 logits;
- the filtered support (``_filter_thresholds``) is identical on the same
  logits;
- sampled streams are reproducible within the port but are not JAX's
  bits. JAX draws its Gumbel noise from per-slot threefry keys, which
  torch cannot reproduce. Here each slot keeps an int64 ``[seed,
  counter]`` state on the device; a counter-based hash of (seed,
  counter, vocab index) gives the noise, and each sample advances the
  counter. A request's stream depends only on its seed, whatever shares
  the batch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_NEG_INF = -1e30
_FAST_PREFIX_K = 256
_M32 = 0xFFFFFFFF


def _thresholds_from_prefix(prefix, denom, m, top_p, k):
    """Threshold math over a descending prefix of the scaled logits.
    prefix [B, K]; denom [B] survivor mass in exp(x - m) units; m [B] row
    max; k [B] effective top-k (0 = off) → [B, 1] threshold."""
    K = prefix.shape[-1]
    idx = (k - 1).clamp(0, K - 1).to(torch.long)[:, None]
    kth = torch.gather(prefix, 1, idx)
    k_thresh = torch.where((k > 0)[:, None], kth, _NEG_INF)
    limit = torch.where(k > 0, k, K)
    in_topk = torch.arange(K, device=prefix.device)[None, :] < limit[:, None]
    e = torch.where(in_topk, torch.exp(prefix - m[:, None]), 0.0)
    cum = torch.cumsum(e, dim=-1)
    keep = in_topk & ((cum - e) < top_p[:, None] * denom[:, None])
    p_thresh = torch.where(keep, prefix, torch.inf).amin(dim=-1, keepdim=True)
    return torch.maximum(k_thresh, p_thresh)


def _filter_thresholds(scaled, top_p, top_k):
    """Per-row admission threshold combining top-k and top-p.
    scaled [B, V] temperature-scaled logits; top_p [B] (>= 1 disables);
    top_k [B] int (<= 0 disables) → [B, 1]."""
    V = scaled.shape[-1]
    k = top_k.clamp(0, V)
    K = min(_FAST_PREFIX_K, V)

    prefix = torch.topk(scaled, K, dim=-1, sorted=True).values
    m = prefix[:, 0]
    cum_prefix = torch.cumsum(torch.exp(prefix - m[:, None]), dim=-1)
    z_all = torch.exp(scaled - m[:, None]).sum(dim=-1)
    k_in_prefix = (k > 0) & (k <= K)
    kidx = (k - 1).clamp(0, K - 1).to(torch.long)[:, None]
    denom = torch.where(k_in_prefix, torch.gather(cum_prefix, 1, kidx)[:, 0], z_all)
    # Both knobs off admits the whole vocabulary (and keeps the batch
    # on the fast path).
    no_filter = (top_p >= 1.0) & (k <= 0)
    fast = torch.where(
        no_filter[:, None], _NEG_INF,
        _thresholds_from_prefix(prefix, denom, m, top_p, k),
    )
    if K == V:
        return fast

    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    cum_full = torch.cumsum(torch.exp(sorted_desc - m[:, None]), dim=-1)
    fidx = (k - 1).clamp(0, V - 1).to(torch.long)[:, None]
    denom_full = torch.where(
        k > 0, torch.gather(cum_full, 1, fidx)[:, 0], cum_full[:, -1]
    )
    slow = _thresholds_from_prefix(sorted_desc, denom_full, m, top_p, k)
    feasible = torch.all(
        no_filter
        | (k_in_prefix | ((k <= 0) & (cum_prefix[:, -1] >= top_p * z_all)))
    )
    return torch.where(feasible, fast, slow)


def _prepare(logits, temperature, top_p, top_k, mask_bias=None):
    B = logits.shape[0]
    logits = logits.float()
    if mask_bias is not None:
        # Grammar: an additive mask (0 admissible, -1e30 masked), applied
        # before the greedy argmax and the filter thresholds so that
        # greedy, top-k and top-p all sample inside the grammar.
        logits = logits + mask_bias
    if isinstance(top_k, int):
        top_k = torch.full((B,), top_k, dtype=torch.int32, device=logits.device)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    thresh = _filter_thresholds(scaled, top_p, top_k.to(torch.int32))
    filtered = torch.where(scaled < thresh, _NEG_INF, scaled)
    return filtered, greedy_tok


def _mul32(x, c: int):
    """x * c mod 2**32 for uint32 values held in int64 (no overflow)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(key_data: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise [B, vocab] f32 from per-slot int64 [seed, counter]
    states [B, 2]: a hash of (seed, counter, vocab index)."""
    seed, ctr = key_data[:, 0], key_data[:, 1]
    hb = _fmix32((seed & _M32) ^ _fmix32(((seed >> 32) & _M32)
                                         ^ _fmix32((ctr & _M32) ^ 0x9E3779B9)))
    iv = torch.arange(vocab, dtype=torch.int64, device=key_data.device)
    hv = _fmix32((iv + 0x632BE5AB) & _M32)
    bits = _fmix32(hb[:, None] ^ hv[None, :])
    # u lies in (0, 1): (2^24 - 1) + 0.5 rounds up to 2^24 in f32, so the
    # top value is clamped below 1, where the noise would be +inf and its
    # token would win over every mask and filter.
    u = torch.clamp(((bits >> 8).float() + 0.5) * (2.0 ** -24), max=1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))


def sample_tokens_per_slot(logits: torch.Tensor, key_data: torch.Tensor,
                           temperature: torch.Tensor, top_p: torch.Tensor,
                           top_k: Union[int, torch.Tensor] = 0,
                           mask_bias: Optional[torch.Tensor] = None):
    """logits [B, V]; key_data int64 [B, 2] per-slot [seed, counter];
    temperature [B] (<= 0 → greedy); top_p [B]; top_k int or [B] int;
    mask_bias an optional additive [B, V] grammar mask. Returns (tokens
    int32 [B], new key_data [B, 2]); every slot's counter advances by
    one, greedy or not."""
    filtered, greedy_tok = _prepare(logits, temperature, top_p, top_k, mask_bias)
    noise = gumbel_noise(key_data, filtered.shape[-1])
    sampled_tok = torch.argmax(filtered + noise, dim=-1).to(torch.int32)
    tok = torch.where(temperature <= 0.0, greedy_tok, sampled_tok)
    new_key_data = torch.stack([key_data[:, 0], key_data[:, 1] + 1], dim=1)
    return tok, new_key_data


def make_slot_key_data(seed: int, device=None) -> torch.Tensor:
    """int64 [2] sampler state for one slot from an integer seed."""
    return torch.tensor([seed, 0], dtype=torch.int64, device=device)

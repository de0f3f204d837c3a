"""The serving engine's device programs (port of the plain, non-ring,
non-grammar programs of ``omnia_tpu/engine/programs.py``).

- ``prefill_insert``: a fresh bucketed prefill whose KV chunk is written
  WHOLE into the slot's rows 0..bucket-1 (pad rows sit past every real
  query position, so the causal mask hides them until decode overwrites
  them), then the first token sampled from the last real position. An
  int8 cache quantizes the chunk as it is written; a paged cache writes
  it through the slot's table row, which placement has made cover the
  bucket.
- ``decode_fns[k]``: ``k`` decode steps enqueued back to back. JAX's
  ``lax.scan`` becomes a Python loop over device tensors: no host sync
  inside a chunk, and stop-token / budget finishes are masked on the
  device, so a slot that finishes mid-chunk stops advancing.
- ``extend`` / ``extend_nosample``: one piece of an incremental prefill
  against the slot's resident rows, with or without the first-token
  sample. JAX copies the slot out, runs the forward and writes it back
  (its arrays are immutable); here the forward runs on a one-slot view
  that writes in place: ``c[:, slot:slot+1]`` of a contiguous or int8
  cache, ``PagedKV(pool, table[slot:slot+1])`` of a paged one. A T == 1
  piece on the card therefore runs the engine's own decode-attention
  kernel with B = 1.
- ``offload`` / ``restore``: a session's leading rows out to a device
  copy ``[L, rows, Hkv, D]`` (the caller moves it to the host) and back
  into a slot's rows 0..rows-1, verbatim in the cache's representation.

PyTorch launches are asynchronous, so every program returns as soon as
its work is enqueued; the caller reads tokens when it needs them. KV
caches are updated in place (JAX donates and returns them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from omnia_tpu_torch.engine.types import EngineConfig
from omnia_tpu_torch.models import ModelConfig, llama
from omnia_tpu_torch.models.kv_quant import cache_put, cache_take, kv_map
from omnia_tpu_torch.models.paged_kv import PagedKV, gather_rows, put_chunk
from omnia_tpu_torch.ops.sampling import sample_tokens_per_slot


@dataclasses.dataclass(frozen=True)
class EnginePrograms:
    prefill_insert: Callable
    decode_fns: dict[int, Callable]
    extend: Callable
    extend_nosample: Callable
    offload: Callable
    restore: Callable


def build_programs(cfg: ModelConfig, ecfg: EngineConfig) -> EnginePrograms:
    max_seq = ecfg.max_seq
    paged = ecfg.kv_pages > 0

    def _put(c, chunk, slot, start):
        """Write a slot-row chunk [L, 1, T, H, D] at rows [start, start+T)."""
        if paged:
            return put_chunk(c, chunk, slot, start)
        return cache_put(c, chunk, (0, slot, start))

    def _slot_view(c, slot):
        """One slot's [L, 1, S, H, D] view of an engine cache; forward's
        writes through it land in the cache."""
        if paged:
            return PagedKV(c.pool, c.table[slot:slot + 1])
        return kv_map(lambda a: a[:, slot:slot + 1], c)

    def _sample_one(logits, key_data, temp, top_p, top_k):
        tok, new_kd = sample_tokens_per_slot(logits, key_data[None], temp, top_p, top_k)
        return tok[0], new_kd[0]

    def prefill_insert(params, ck, cv, tokens, positions, slot: int,
                       last_idx: int, key_data, temp, top_p, top_k):
        """tokens, positions [1, bucket]; key_data [2]; temp, top_p,
        top_k [1] → (first token 0-d int32, new key_data [2])."""
        logits, k_chunk, v_chunk = llama.forward_prefill(params, cfg, tokens, positions)
        _put(ck, k_chunk, slot, 0)
        _put(cv, v_chunk, slot, 0)
        return _sample_one(logits[:, last_idx], key_data, temp, top_p, top_k)

    def extend_nosample(params, ck, cv, tokens, positions, slot: int, write_start):
        """tokens, positions [1, T]; write_start int32 [1] → logits
        [1, T, V]: the piece's rows written into the slot."""
        logits, _, _ = llama.forward(params, cfg, tokens, positions,
                                     _slot_view(ck, slot), _slot_view(cv, slot),
                                     write_start)
        return logits

    def extend(params, ck, cv, tokens, positions, slot: int, write_start,
               last_idx: int, key_data, temp, top_p, top_k):
        """The final piece: extend_nosample, then the first token sampled
        at ``last_idx`` → (token 0-d int32, new key_data [2])."""
        logits = extend_nosample(params, ck, cv, tokens, positions, slot, write_start)
        return _sample_one(logits[:, last_idx], key_data, temp, top_p, top_k)

    def offload(ck, cv, slot: int, rows: int):
        """A slot's rows [0, rows) → [L, rows, H, D] on the device: a
        view of a contiguous cache, a gather of the pages covering them
        from a paged one. The caller copies them to the host at once."""
        if paged:
            return gather_rows(ck, slot, rows), gather_rows(cv, slot, rows)
        L = ck.shape[0]
        return tuple(kv_map(lambda a: a[:, 0], cache_take(c, (0, slot, 0), (L, 1, rows)))
                     for c in (ck, cv))

    def restore(ck, cv, k_rows, v_rows, slot: int):
        """rows [L, R, H, D] (cache representation) → the slot's rows [0, R)."""
        _put(ck, kv_map(lambda a: a[:, None], k_rows), slot, 0)
        _put(cv, kv_map(lambda a: a[:, None], v_rows), slot, 0)

    def make_decode(chunk: int) -> Callable:
        def decode_chunk(params, ck, cv, tokens, positions, active, budget,
                         stop_ids, key_data, temp, top_p, top_k):
            """``chunk`` decode steps → (ck, cv, tokens, positions, active,
            budget, key_data, toks [chunk, B])."""
            toks = []
            for _ in range(chunk):
                logits, ck, cv = llama.forward(
                    params, cfg, tokens[:, None], positions[:, None], ck, cv,
                    positions,
                )
                tok, key_data = sample_tokens_per_slot(
                    logits[:, 0], key_data, temp, top_p, top_k
                )
                # The row just written advances the position only for slots
                # active at the step's start; deactivation applies from the
                # next step on, as the host's finish bookkeeping does.
                positions = torch.where(
                    active, torch.clamp(positions + 1, max=max_seq - 1), positions
                )
                budget = budget - active.to(torch.int32)
                hit_stop = (tok[:, None] == stop_ids).any(dim=1)
                active = active & ~hit_stop & (budget > 0)
                tokens = torch.where(active | hit_stop, tok, tokens)
                toks.append(tok)
            return (ck, cv, tokens, positions, active, budget, key_data,
                    torch.stack(toks))

        decode_chunk.__name__ = f"decode_chunk_{chunk}"
        return decode_chunk

    return EnginePrograms(
        prefill_insert=prefill_insert,
        decode_fns={k: make_decode(k) for k in ecfg.chunk_variants()},
        extend=extend,
        extend_nosample=extend_nosample,
        offload=offload,
        restore=restore,
    )

"""The serving engine's device programs (port of the fresh-prefill and
plain chunked-decode programs of ``omnia_tpu/engine/programs.py``).

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
from omnia_tpu_torch.models.kv_quant import cache_put
from omnia_tpu_torch.models.paged_kv import put_chunk
from omnia_tpu_torch.ops.sampling import sample_tokens_per_slot


@dataclasses.dataclass(frozen=True)
class EnginePrograms:
    prefill_insert: Callable
    decode_fns: dict[int, Callable]


def build_programs(cfg: ModelConfig, ecfg: EngineConfig) -> EnginePrograms:
    max_seq = ecfg.max_seq
    paged = ecfg.kv_pages > 0

    def _put(c, chunk, slot):
        """Write a slot-row chunk [L, 1, T, H, D] at rows [0, T)."""
        if paged:
            return put_chunk(c, chunk, slot, 0)
        return cache_put(c, chunk, (0, slot, 0))

    def prefill_insert(params, ck, cv, tokens, positions, slot: int,
                       last_idx: int, key_data, temp, top_p, top_k):
        """tokens, positions [1, bucket]; key_data [2]; temp, top_p,
        top_k [1] → (first token 0-d int32, new key_data [2])."""
        logits, k_chunk, v_chunk = llama.forward_prefill(params, cfg, tokens, positions)
        _put(ck, k_chunk, slot)
        _put(cv, v_chunk, slot)
        last = logits[:, last_idx]
        tok, new_kd = sample_tokens_per_slot(last, key_data[None], temp, top_p, top_k)
        return tok[0], new_kd[0]

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
    )

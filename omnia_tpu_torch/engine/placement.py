"""Request placement (port of the fresh branch of
``omnia_tpu/engine/placement.py``): a queued request goes to its first
sampled token through one bucketed fresh prefill.

Session reuse and the chunked extend of prompts longer than the largest
bucket are not ported yet (ROADMAP A6); ``submit`` refuses both.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from omnia_tpu_torch.engine.types import (
    MAX_DEVICE_STOP_IDS,
    Request,
    RequestHandle,
    SamplingParams,
)
from omnia_tpu_torch.ops.sampling import make_slot_key_data


class _PlacementMixin:
    """Placement methods of :class:`InferenceEngine`."""

    def _sampling_key(self, slot_idx: int, sp: SamplingParams) -> torch.Tensor:
        if sp.seed is not None:
            return make_slot_key_data(sp.seed, self.device)
        return self._key_data[slot_idx]

    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.tensor([value], dtype=dtype, device=self.device)

    def _place_request(self, slot_idx: int, request: Request, handle: RequestHandle):
        prompt = request.prompt_tokens
        n = len(prompt)
        sp = request.params
        t_prefill = time.monotonic()
        # Every prefill dispatched while a decode slot is live stalls the
        # decode batch for its duration.
        stalled = any(s.active for s in self._slots)
        # Paged pool: a cold start owns no history; return any stale
        # pages before the bucket write allocates fresh ones.
        self._free_slot_pages(slot_idx)
        first_tok = self._fresh_prefill(slot_idx, prompt, sp)
        # Paged pool: the bucket-padded prefill covered rows past the
        # prompt; return that slack now. The next decode write gets its
        # page in the pre-dispatch preallocation.
        self._trim_slot_pages(slot_idx, n)
        if stalled:
            self.metrics["decode_stall_steps"] += 1
        self.metrics["prefill_dispatch_s"] += time.monotonic() - t_prefill
        self.metrics["prefill_tokens"] += n
        self.metrics["prefill_steps"] += 1

        slot = self._slots[slot_idx]
        slot.request = request
        slot.handle = handle
        slot.length = n
        slot.generated = 0
        slot.emitted = []
        slot.max_total = sp.max_tokens
        slot.stop_ids = frozenset(sp.stop_token_ids)

        self._tokens[slot_idx] = first_tok
        self._positions[slot_idx] = n
        self._active[slot_idx] = True
        self._temp[slot_idx] = sp.temperature
        self._top_p[slot_idx] = sp.top_p
        self._top_k[slot_idx] = sp.top_k
        # Device-side finish state: emissions still allowed after the
        # first token. It must equal the host's finish schedule exactly
        # (generated >= max_tokens or length >= max_seq - 2). Stop ids
        # past MAX_DEVICE_STOP_IDS are checked on the host only.
        budget = min(sp.max_tokens - 1, self.cfg.max_seq - 2 - n)
        self._budget[slot_idx] = max(budget, 0)
        ids = list(sp.stop_token_ids)[:MAX_DEVICE_STOP_IDS]
        ids += [-1] * (MAX_DEVICE_STOP_IDS - len(ids))
        self._stop_ids[slot_idx] = torch.tensor(ids, dtype=torch.int32)
        self._emit_token(slot_idx, int(first_tok))

    def _fresh_prefill(self, slot_idx: int, prompt: list[int], sp: SamplingParams):
        n = len(prompt)
        bucket = self.cfg.bucket_for(n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt
        pos = np.arange(bucket, dtype=np.int32)[None, :]
        # Paged pool: the prefill writes the whole bucket, so exclusive
        # pages must cover it before dispatch (PoolExhausted otherwise).
        self._prepare_slot_write(slot_idx, 0, bucket)
        first_tok, new_kd = self._prefill_insert_fn(
            self.params, self._ck, self._cv,
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device),
            slot_idx, n - 1, self._sampling_key(slot_idx, sp),
            self._scalar(sp.temperature, torch.float32),
            self._scalar(sp.top_p, torch.float32),
            self._scalar(sp.top_k, torch.int32),
        )
        self._key_data[slot_idx] = new_kd
        return first_tok

"""Stall-free batching (port of ``omnia_tpu/engine/interleave.py``;
``EngineConfig.prefill_chunk_tokens``).

An arriving prompt is split into pieces of at most
``prefill_chunk_tokens`` tokens, and each piece rides one mixed step
(programs.py ``mixed``) that also advances every active slot by one
decode token. A long prompt then delays the decoding requests by one
mixed step at a time instead of by its whole prefill, and the decode
pipeline stays full while requests queue.

- **Tokens.** A piece runs the extend seam of a chunked extend, and the
  decode half is the chunk's ``_step``, so the tokens are those of
  prefill-first serving; the KV rows agree within f32 rounding (a piece
  attends the slot's resident rows where a fresh prefill attends its own
  chunk).
- **Garbage rows.** The placing slot is inactive in every decode half;
  its frozen position is parked at the piece's end, so the garbage row
  lands at the new frontier, which the next piece (or the first real
  decode write) overwrites. The forward writes in place, so a wrong park
  would overwrite real prompt rows at once.
- **Exact partial books.** ``prefill_tokens`` and
  ``interleaved_prefill_tokens`` count per piece and a session's
  ``token_ids`` advance with the frontier, so a deadline or a cancel
  mid-prefill leaves exact counts and reusable rows.

At most one prefill is in flight (``self._prefilling``); with the knob
off it stays None and nothing here runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch.engine.types import FinishReason, Request, RequestHandle


@dataclasses.dataclass
class _InflightPrefill:
    """A placement mid-interleave: its claimed slot and piece plan."""

    slot_idx: int
    request: Request
    handle: RequestHandle
    sess: Optional[object]          # _SessionKV or None
    pieces: list                    # [(offset, real_len, bucket)]
    next_piece: int = 0
    frontier: int = 0               # rows known valid (reuse / seed + consumed)
    reuse: int = 0                  # session-LCP rows (flight-recorder attrs)
    seeded: int = 0                 # rows seeded from the prefix pool (same)

    @property
    def prompt(self) -> list[int]:
        return self.request.prompt_tokens


class _InterleaveMixin:
    """Mixed-step scheduling methods of :class:`InferenceEngine`."""

    def _mixed_enabled(self) -> bool:
        return self.cfg.prefill_chunk_tokens > 0

    def pending_prefill_tokens(self) -> int:
        """Prompt-token backlog: queued prompts plus the unconsumed tail
        of the in-flight interleaved prefill (the coordinator's load
        signal)."""
        with self._lock:
            backlog = sum(len(r.prompt_tokens) for r, _h in self._waiting)
        pf = self._prefilling
        if pf is not None:
            backlog += max(len(pf.prompt) - pf.frontier, 0)
        return backlog

    # -- step loop ---------------------------------------------------------

    def _step_mixed(self) -> bool:
        """One scheduling step under the token-budget policy."""
        did = False
        if self._prefilling is None:
            pending, slot_idx = self._claim_pending()
            if pending is not None:
                did = True
                request, handle = pending
                if any(s.active for s in self._slots):
                    self._begin_interleaved_prefill(slot_idx, request, handle)
                else:
                    # Nothing decodes, so nothing stalls: one monolithic
                    # placement costs fewer enqueues.
                    self._place_pending(slot_idx, request, handle)
        pf = self._prefilling
        if pf is not None:
            try:
                self._dispatch_mixed(pf)
            except Exception:
                self._fail_prefilling("prefill failed")
                raise
            while len(self._inflight) >= max(1, self.cfg.decode_pipeline):
                self._process_oldest_chunk()
            return True
        if any(s.active for s in self._slots):
            if self._spec_step():
                return True
            with self._lock:
                queued = bool(self._waiting)
            if queued and self._inflight:
                # The queue waits on a slot here (a placeable request
                # would have begun above): surface finishes now, but keep
                # enqueueing full chunks.
                self._flush_pipeline()
            if self._inflight and not self._dispatch_ahead_useful():
                self._process_oldest_chunk()
            else:
                self._dispatch_decode()
                while len(self._inflight) >= max(1, self.cfg.decode_pipeline):
                    self._process_oldest_chunk()
            return True
        if self._inflight:
            self._process_oldest_chunk()
            return True
        return did

    # -- placement -----------------------------------------------------------

    def _budget_pieces(self, start: int, count: int) -> list[tuple[int, int, int]]:
        """(offset, real_len, bucket) pieces covering prompt[start:
        start+count], each of at most ``prefill_chunk_tokens`` tokens.
        As in ``_extend_pieces``, a bucket-padded write must never cross
        the cache end, so the tail there degrades to 1-token pieces."""
        buckets = sorted(self.cfg.usable_buckets())
        budget = self.cfg.prefill_chunk_tokens
        S = self.cfg.max_seq
        pieces = []
        pos, left = start, count
        while left > 0:
            take = min(left, budget, buckets[-1])
            b = self.cfg.bucket_for(take)
            if pos + b > S:
                b = 1
                take = 1
            pieces.append((pos, take, b))
            pos += take
            left -= take
        return pieces

    def _begin_interleaved_prefill(self, slot_idx: int, request: Request,
                                   handle: RequestHandle) -> None:
        """Claim the slot and plan the pieces; ``_dispatch_mixed`` sends
        one per step. The ``_placing`` claim of ``_claim_pending`` is held
        for the whole interleave, so drain and recovery see the work."""
        try:
            prompt = request.prompt_tokens
            slot_idx, sess, reuse = self._prepare_session_slot(slot_idx, request)
            t0 = time.monotonic()
            seeded = self._try_seed_from_pool(slot_idx, prompt, sess) if reuse == 0 else 0
            self.metrics["prefill_dispatch_s"] += time.monotonic() - t0
            self.metrics["prefix_reuse_tokens"] += reuse
            frontier = reuse or seeded
            if frontier == 0:
                # Paged pool: a cold start returns stale pages first.
                self._free_slot_pages(slot_idx)
            if sess is not None:
                # The pieces overwrite rows from the frontier on: a longer
                # stale claim (a diverged previous turn) drops now.
                sess.token_ids = list(prompt[:frontier])
            self._prefilling = _InflightPrefill(
                slot_idx=slot_idx, request=request, handle=handle, sess=sess,
                pieces=self._budget_pieces(frontier, len(prompt) - frontier),
                frontier=frontier, reuse=reuse, seeded=seeded,
            )
        except Exception:
            self._fail_placement(slot_idx, request, handle, "prefill failed")
            with self._lock:
                self._placing -= 1
            raise

    def _dispatch_mixed(self, pf: _InflightPrefill) -> None:
        """One mixed step: the next piece and one decode step for every
        active slot. The decode tokens are read later, like a chunk's.

        With speculation engaged the verify window rides the same step
        (``mixed_spec``): greedy slots verify while sampled slots take the
        exact decode step. Acceptance needs the window's tokens at once,
        so such a step is synchronous and the pipeline is flushed before
        planning."""
        off, take, bucket = pf.pieces[pf.next_piece]
        final = pf.next_piece == len(pf.pieces) - 1
        plan = None
        if self._spec_engaged():
            park = {pf.slot_idx: off + take}
            depths: dict = {}  # one cooldown advance per step
            if self._spec_plan(park=park, depths=depths) is not None:
                if self._inflight:
                    self._flush_pipeline()
                plan = self._spec_plan(park=park, depths=depths)
        active = [(i, s.request.request_id) for i, s in enumerate(self._slots)
                  if s.active and (plan is None or not plan.vmask[i])]
        # Park the placing slot's frozen decode row at the piece's end:
        # the piece is written first, so the decode half's garbage lands
        # at the new frontier.
        li = self._dp.local(pf.slot_idx)
        if li is not None:
            self._positions[li] = off + take
        # Paged pool: owned pages through the piece's bucket end for the
        # placing slot, and one decode row for every active slot.
        self._prepare_slot_write(pf.slot_idx, off, min(off + bucket, self.cfg.max_seq))
        self._prealloc_decode_pages(1)
        spec_args = ()
        mixed_fns, mixed_sample_fns = self._mixed_fns, self._mixed_sample_fns
        if plan is not None:
            self._prepare_verify_pages()
            spec_args = self._plan_tensors(plan)
            mixed_fns, mixed_sample_fns = self._mixed_spec_fns, self._mixed_spec_sample_fns
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :take] = pf.prompt[off:off + take]
        ppos = (off + np.arange(bucket, dtype=np.int32))[None, :]
        decode = (self.params, self._ck, self._cv, self._tokens, self._positions, self._active,
                  self._budget, self._stop_ids, self._key_data, self._temp, self._top_p,
                  self._top_k)
        args = decode + (torch.from_numpy(toks).to(self.device),
                         torch.from_numpy(ppos).to(self.device), li,
                         self._scalar(off, torch.int32))
        gargs = (self._gstate, self._gtable, self._gactive) if self._gr_on else ()
        t_dispatch = time.monotonic()
        first_tok = new_pkd = greedy = None
        if li is None:
            # Another dp shard places: this shard takes the step's decode
            # half alone (the verify window with it when speculating).
            if plan is not None:
                out = self._verify_decode_fn(*decode, *spec_args, *gargs)
            else:
                out = self._decode_plain_fn(*decode, *gargs)
        elif final:
            sp = pf.request.params
            out = mixed_sample_fns[bucket](*args, *spec_args, take - 1,
                                           *self._sampler_args(pf.slot_idx, sp),
                                           *self._grammar_args(pf.request, sp), *gargs)
        else:
            out = mixed_fns[bucket](*args, *spec_args, *gargs)
        if plan is not None:
            greedy, out = self._dp.gather(out[-1], dim=0), out[:-1]
        if final and li is not None:
            first_tok, new_pkd = out[-2:]
            out = out[:-2]
        self._adopt_decode_state(out)
        dtoks = self._dp.gather(out[-1], dim=1)
        if final:
            first_tok = self._first_token(first_tok, pf.slot_idx)
        dispatch_s = time.monotonic() - t_dispatch
        self.metrics["decode_dispatch_s"] += dispatch_s
        self.metrics["decode_steps"] += 1
        self.metrics["mixed_steps"] += 1
        self.metrics["interleaved_prefill_tokens"] += take
        self.metrics["prefill_tokens"] += take
        if self._flight is not None:
            self._flight.note_mixed_step(pf.request.request_id, take, bucket, dispatch_s)
        # The decode half rides the pipeline (and the ring) like a chunk
        # of one step; mixed steps stay eager on the card.
        self._push_inflight(dtoks, active, dispatch_s)
        if plan is not None:
            t_sync = time.monotonic()
            g = greedy.cpu().numpy()
            sync_s = time.monotonic() - t_sync
            self.metrics["decode_sync_s"] += sync_s
            self.metrics["spec_steps"] += 1
            self._spec_accept(plan, g, dispatch_s, sync_s)
        pf.next_piece += 1
        pf.frontier = off + take
        if pf.sess is not None:
            # The consumed rows are valid prompt rows: a deadline or a
            # cancel now leaves the next turn [0, frontier) to reuse.
            pf.sess.token_ids = list(pf.prompt[:pf.frontier])
            pf.sess.last_used = self.clock()
        if final:
            self._complete_interleaved(pf, first_tok, new_pkd)

    def _complete_interleaved(self, pf: _InflightPrefill, first_tok, new_pkd) -> None:
        """The final piece sampled the first token: the back half of
        placement, against the mixed step's advanced decode state (the
        slot's position already sits at the prompt's end)."""
        slot_idx, prompt = pf.slot_idx, pf.prompt
        if pf.sess is not None:
            pf.sess.token_ids = list(prompt)
        self._maybe_publish_prefix(slot_idx, prompt)
        # Paged pool: drop the final piece's bucket slack (after publish
        # shared the prefix pages).
        self._trim_slot_pages(slot_idx, len(prompt))
        self.metrics["prefill_steps"] += 1
        if new_pkd is not None:
            self._key_data[self._dp.local(slot_idx)] = new_pkd
        self._prefilling = None
        with self._lock:
            self._placing -= 1
        # The mixed steps already counted the prefill's time.
        self._activate_slot(slot_idx, pf.request, pf.handle, first_tok, reuse=pf.reuse,
                            seeded=pf.seeded)

    # -- abort / failure -------------------------------------------------------

    def _abort_prefilling(self, reason: FinishReason) -> None:
        """Terminal for a half-prefilled request (deadline or cancel): the
        consumed rows stay valid for the session, the books are already
        exact, and the slot quiesces at the consumed frontier."""
        pf = self._prefilling
        self._prefilling = None
        slot = self._slots[pf.slot_idx]
        self._push_final(pf.handle, pf.request.request_id, reason,
                         num_prompt_tokens=len(pf.prompt))
        self.metrics["requests_finished"] += 1
        if self._flight is not None:
            self._flight.note_terminal(pf.request.request_id, reason.value)
        quiesce_row = 0
        if pf.sess is not None:
            quiesce_row = len(pf.sess.token_ids)
        else:
            self._release_slot_seed(slot)
        slot.clear()
        # Paged pool: only the pages below the consumed frontier stay.
        self._trim_slot_pages(pf.slot_idx, quiesce_row)
        if self._dp.local(pf.slot_idx) is not None:
            self._positions[self._dp.local(pf.slot_idx)] = quiesce_row
        with self._lock:
            self._placing -= 1

    def _fail_prefilling(self, msg: str) -> None:
        """Hard failure of the in-flight prefill (a raised enqueue,
        recovery, ``_fail_all``): the placement failure's terminal."""
        pf = self._prefilling
        if pf is None:
            return
        self._prefilling = None
        self._fail_placement(pf.slot_idx, pf.request, pf.handle, msg)
        with self._lock:
            self._placing -= 1

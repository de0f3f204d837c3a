"""Request placement (port of ``omnia_tpu/engine/placement.py``): a
queued request goes to its first sampled token through one bucketed
fresh prefill when nothing is reusable and the prompt fits a bucket,
else through a chunked extend from the reuse frontier: the session's
own rows, or rows seeded from the shared-prefix pool (or from row 0
for a long prompt). A grammar request gets its start-state mask on the
first token and its table and FSM state in the slot's device rows.

Under data parallelism every rank places every request in its host
books; only the slot's owner shard runs the slot's programs and writes
its device rows, and the first token reaches the other shards by one
broadcast over dp (``dataparallel.py``). A fresh prompt whose bucket
reaches ``long_prefill_threshold`` (and splits over sp) prefills as the
ring (``prefill_ring`` then ``insert``).

A fresh prefill goes through ``_prefill_insert_fn``, which replays the
bucket's captured graph where the engine's prefill graphs engage (on the
card with the decode ring on, one rank, a contiguous cache:
``prefill_graphs.py``) and runs the eager ``prefill_insert`` elsewhere.
An engine never warmed captures them at its first fresh prefill, before
the program's mark on the timeline. Extend pieces stay eager.

Grammars are duck-typed: one compiled by this package or by the JAX
package serves alike, since placement reads only ``view``, ``key`` and
``eos_id`` and a view's ``table``, ``start``, ``advance`` and
``num_states``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch.engine.sessions import _SessionKV
from omnia_tpu_torch.engine.types import (
    MAX_DEVICE_STOP_IDS,
    Request,
    RequestHandle,
    SamplingParams,
)
from omnia_tpu_torch.engine.grammar import GrammarTooLarge
from omnia_tpu_torch.ops.sampling import _NEG_INF, make_slot_key_data


class _PlacementMixin:
    """Placement methods of :class:`InferenceEngine`."""

    def _sampling_key(self, slot_idx: int, sp: SamplingParams) -> torch.Tensor:
        """The first-token sampler's key: the request's seed, else the
        slot's own key (read on the slot's dp shard)."""
        if sp.seed is not None:
            return make_slot_key_data(sp.seed, self.device)
        return self._key_data[self._dp.local(slot_idx)]

    def _program_start(self):
        """A mark on the device's timeline before a prefill, extend or
        insert program is enqueued (``utils/timeline.py``); None with the
        flight recorder off."""
        return self._timeline.mark() if self._timeline is not None else None

    def _note_piece(self, rid: str, take: int, bucket: int, t0: float, start) -> None:
        """A placement program enqueued since ``t0`` (host) and ``start``
        (its mark, None where this shard ran none): its flight event, and
        its event pair, which the timeline resolves once it has run."""
        if self._flight is None:
            return
        event = None
        if rid:
            event = self._flight.note_prefill_piece(rid, take, bucket, time.monotonic() - t0)
        if start is not None:
            self._timeline.program(start, event)

    def _prefill_insert_fn(self, params, ck, cv, tokens, positions, slot: int, last_idx: int,
                           *sampler):
        """``programs.prefill_insert`` (its signature and result): a replay
        of the bucket's captured graph where the engine's prefill graphs
        serve this call's bucket and state (``prefill_graphs.py``), else
        the eager program: on any other state (warmup's tasks run before
        the capture), and on engines where the graphs do not engage."""
        graphs = self._fresh_graphs
        if graphs is not None and graphs.serves(params, ck, cv, tokens.shape[1]):
            self.metrics["prefill_graph_replays"] += 1
            return graphs.replay(tokens, positions, slot, last_idx, *sampler)
        return self._prefill_program(params, ck, cv, tokens, positions, slot, last_idx,
                                     *sampler)

    def _scalar(self, value, dtype) -> torch.Tensor:
        return torch.tensor([value], dtype=dtype, device=self.device)

    def _sampler_args(self, slot_idx: int, sp: SamplingParams) -> tuple:
        return (self._sampling_key(slot_idx, sp),
                self._scalar(sp.temperature, torch.float32),
                self._scalar(sp.top_p, torch.float32),
                self._scalar(sp.top_k, torch.int32))

    # -- grammar ----------------------------------------------------------

    def _validate_grammar(self, grammar, sp: SamplingParams) -> Optional[str]:
        """Submit-time refusal with the JAX engine's messages: budget and
        liveness on the exact view placement uploads. A ValueError covers
        both packages' GrammarError."""
        if not self._gr_on:
            return "grammar-constrained request on an engine built with grammar=off"
        try:
            grammar.validate(self.cfg.grammar_max_states, self.model_cfg.vocab_size,
                             sp.stop_token_ids)
        except ValueError as e:
            return f"grammar rejected: {e}"
        return None

    def _grammar_args(self, request: Optional[Request], sp: SamplingParams) -> tuple:
        """The first-token sampler's extra operand: the start state's mask
        bias [V], zero for a request without a grammar; () with grammar
        support off."""
        if not self._gr_on:
            return ()
        g = request.grammar if request is not None else None
        if g is None:
            return (self._gbias_zero,)
        view = g.view(self.model_cfg.vocab_size, sp.stop_token_ids)
        bias = np.where(view.table[view.start] < 0, _NEG_INF, 0.0).astype(np.float32)
        return (torch.from_numpy(bias).to(self.device),)

    def _attach_grammar(self, slot_idx: int, request: Request, first_tok: int) -> None:
        """Upload the request's table (unless the slot holds it already)
        and the FSM state after the first token into the slot's device
        rows; mirror the state on the host slot."""
        if not self._gr_on:
            return
        g = request.grammar
        li = self._dp.local(slot_idx)
        if g is None:
            if li is not None:
                self._gactive[li] = False
            return
        sp = request.params
        view = g.view(self.model_cfg.vocab_size, sp.stop_token_ids)
        state0 = view.advance(view.start, first_tok)
        if state0 < 0:  # the first token finished the request (a stop id)
            state0 = view.start
        # Keyed on the grammar object itself when it has no content key,
        # which pins it alive so that a recycled id() never aliases. Rows
        # past num_states are never reached, so a stale tail is harmless.
        gkey = (g.key or g, tuple(sorted({g.eos_id, *sp.stop_token_ids})))
        if self._gslot_key[slot_idx] != gkey:
            if view.num_states > self.cfg.grammar_max_states:
                raise GrammarTooLarge(
                    f"grammar needs {view.num_states} states, engine "
                    f"grammar_max_states is {self.cfg.grammar_max_states}"
                )
            if li is not None:
                self._gtable[li, :view.num_states] = torch.from_numpy(
                    np.ascontiguousarray(view.table)).to(self.device)
            self._gslot_key[slot_idx] = gkey
        if li is not None:
            self._gstate[li] = state0
            self._gactive[li] = True
        slot = self._slots[slot_idx]
        slot.gr_view = view
        slot.gr_state = view.start  # _emit_token advances past first_tok
        if self._flight is not None:
            self._flight.note_grammar_attach(request.request_id, view.num_states)

    def _prepare_session_slot(self, slot_idx: int, request: Request):
        """The session half of placement: find or create the session,
        take the longest common prefix of the prompt with its cached rows
        (at most n - 1, so a suffix token yields the next logits),
        restore it from host when it reuses any row, and pin the slot.
        Returns ``(slot_idx, sess, reuse)``."""
        prompt = request.prompt_tokens
        n = len(prompt)
        sess = None
        reuse = 0
        if self.cfg.max_sessions > 0 and request.session_id:
            sess = self._sessions.get(request.session_id)
            if sess is None:
                sess = self._sessions[request.session_id] = _SessionKV(
                    request.session_id, now=self.clock()
                )
                self._enforce_session_cap(protect=request.session_id)
            sess.last_used = self.clock()
            limit = min(len(sess.token_ids), n - 1)
            while reuse < limit and sess.token_ids[reuse] == prompt[reuse]:
                reuse += 1
            if sess.slot is None and sess.host_k is not None:
                if reuse > 0:
                    self._restore_session(sess, slot_idx)
                else:
                    sess.host_k = sess.host_v = None  # diverged: useless rows
            if sess.slot is None:
                sess.slot = slot_idx
                self._slots[slot_idx].session_id = sess.session_id
            slot_idx = sess.slot
            if reuse == 0:
                sess.token_ids = []
        return slot_idx, sess, reuse

    def _place_request(self, slot_idx: int, request: Request, handle: RequestHandle):
        prompt = request.prompt_tokens
        n = len(prompt)
        slot_idx, sess, reuse = self._prepare_session_slot(slot_idx, request)
        sp = request.params
        t_prefill = time.monotonic()
        # No rows of its own to extend from: seed the slot from the
        # shared-prefix pool, so a fresh session of a known pack
        # prefills only its suffix.
        seeded = self._try_seed_from_pool(slot_idx, prompt, sess) if reuse == 0 else 0
        frontier = reuse or seeded
        if frontier == 0:
            # Paged pool: a cold start owns no history; return any stale
            # pages before the bucket write allocates fresh ones.
            self._free_slot_pages(slot_idx)
        # Every prefill dispatched while a decode slot is live stalls the
        # decode batch for its duration.
        stalled = any(s.active for s in self._slots)
        ext0 = self.metrics["extend_steps"]
        if frontier == 0 and n <= max(self.cfg.usable_buckets()):
            first_tok = self._fresh_prefill(slot_idx, prompt, sp, request)
        else:
            first_tok = self._chunked_extend(slot_idx, prompt, frontier, sp, request)
        if stalled:
            stall_steps = max(self.metrics["extend_steps"] - ext0, 1)
            self.metrics["decode_stall_steps"] += stall_steps
            if self._flight is not None:
                self._flight.note_stall(stall_steps)
        self._maybe_publish_prefix(slot_idx, prompt)
        # Paged pool: the bucket-padded writes covered rows past the
        # prompt; return that slack now (a publish above already shares
        # the prefix pages). The next decode write gets its page in the
        # pre-dispatch preallocation.
        self._trim_slot_pages(slot_idx, n)
        prefill_s = time.monotonic() - t_prefill
        self.metrics["prefill_dispatch_s"] += prefill_s
        self.metrics["prefix_reuse_tokens"] += reuse
        self.metrics["prefill_tokens"] += n - frontier
        self.metrics["prefill_steps"] += 1

        if sess is not None:
            sess.token_ids = list(prompt)
        self._activate_slot(slot_idx, request, handle, first_tok, reuse=reuse, seeded=seeded,
                            prefill_s=prefill_s, stalled=stalled)

    def _activate_slot(self, slot_idx: int, request: Request, handle: RequestHandle,
                       first_tok, reuse: int = 0, seeded: int = 0, prefill_s: float = 0.0,
                       stalled: bool = False) -> None:
        """The back half of placement, shared with the interleaved path
        (engine/interleave.py): the slot takes the request, the device
        takes its decode state, and the first token is emitted. The
        keywords are the placement's flight-recorder attributes."""
        n = len(request.prompt_tokens)
        sp = request.params
        slot = self._slots[slot_idx]
        slot.request = request
        slot.handle = handle
        slot.length = n
        slot.generated = 0
        slot.emitted = []
        slot.max_total = sp.max_tokens
        if self.cfg.spec_decode:
            slot.spec_reset(self.cfg.spec_decode, self.cfg.spec_decode_max)
        stop_ids = frozenset(sp.stop_token_ids)
        if request.grammar is not None:
            # In its accepting states a grammar view admits only its eos
            # id: the slot must finish on it even when the caller's stop
            # set omits it.
            stop_ids |= {request.grammar.eos_id}
        slot.stop_ids = stop_ids

        li = self._dp.local(slot_idx)
        if li is not None:
            self._tokens[li] = first_tok
            self._positions[li] = n
            self._active[li] = True
            self._temp[li] = sp.temperature
            self._top_p[li] = sp.top_p
            self._top_k[li] = sp.top_k
            # Device-side finish state: emissions still allowed after the
            # first token. It must equal the host's finish schedule exactly
            # (generated >= max_tokens or length >= max_seq - 2). Stop ids
            # past MAX_DEVICE_STOP_IDS are checked on the host only.
            budget = min(sp.max_tokens - 1, self.cfg.max_seq - 2 - n)
            self._budget[li] = max(budget, 0)
            ids = list(sp.stop_token_ids)
            if request.grammar is not None and request.grammar.eos_id not in ids:
                ids.append(request.grammar.eos_id)
            ids = ids[:MAX_DEVICE_STOP_IDS]
            ids += [-1] * (MAX_DEVICE_STOP_IDS - len(ids))
            self._stop_ids[li] = torch.tensor(ids, dtype=torch.int32)
            if self._geos is not None:
                # The ring's per-slot grammar EOS (-1 = none), set at every
                # placement so that a previous occupant's id never leaks.
                self._geos[li] = request.grammar.eos_id if request.grammar is not None else -1
        first = int(first_tok)
        self._attach_grammar(slot_idx, request, first)
        if self._flight is not None:
            # Just before the first token's emit, so that queue (submit →
            # claim) + placement (claim → here) + decode (first token →
            # terminal) tile the request's wall.
            self._flight.note_placement(request.request_id, slot_idx, n, reuse=reuse,
                                        seeded=seeded, prefill_s=prefill_s, stalled=stalled)
        self._emit_token(slot_idx, first)

    def _fresh_prefill(self, slot_idx: int, prompt: list[int], sp: SamplingParams,
                       request: Optional[Request] = None):
        n = len(prompt)
        bucket = self.cfg.bucket_for(n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt
        pos = np.arange(bucket, dtype=np.int32)[None, :]
        # Paged pool: the prefill writes the whole bucket, so exclusive
        # pages must cover it before dispatch (PoolExhausted otherwise).
        self._prepare_slot_write(slot_idx, 0, bucket)
        li = self._dp.local(slot_idx)
        if li is None:
            # Another dp shard's slot: its owner prefills.
            return self._first_token(None, slot_idx)
        toks_d = torch.from_numpy(toks).to(self.device)
        pos_d = torch.from_numpy(pos).to(self.device)
        if (self._prefill_ring_fn is not None and bucket >= self.cfg.long_prefill_threshold
                and bucket % self.cfg.sp == 0):
            # The ring: the sp-split prefill, its chunk then inserted.
            last, k_chunk, v_chunk = self._prefill_ring_fn(self.params, toks_d, pos_d, n - 1)
            first_tok = self._run_insert(k_chunk, v_chunk, slot_idx, last, sp, request)
            return self._first_token(first_tok, slot_idx)
        # An engine never warmed captures its prefill graphs here, before
        # the program's mark.
        self._prefill_graphs()
        t0, start = time.monotonic(), self._program_start()
        first_tok, new_kd = self._prefill_insert_fn(
            self.params, self._ck, self._cv, toks_d, pos_d,
            li, n - 1, *self._sampler_args(slot_idx, sp),
            *self._grammar_args(request, sp),
        )
        self._note_piece(request.request_id if request is not None else "", n, bucket, t0,
                         start)
        self._key_data[li] = new_kd
        return self._first_token(first_tok, slot_idx)

    def _run_insert(self, k_chunk, v_chunk, slot_idx: int, last_logits, sp: SamplingParams,
                    request: Optional[Request] = None):
        """The ring prefill's chunk into the slot (on its owner shard) and
        its first token sampled."""
        li = self._dp.local(slot_idx)
        first_tok, new_kd = self._insert_fn(self._ck, self._cv, k_chunk, v_chunk, li,
                                            last_logits, *self._sampler_args(slot_idx, sp),
                                            *self._grammar_args(request, sp))
        self._key_data[li] = new_kd
        return first_tok

    def _extend_pieces(self, start: int, count: int) -> list[tuple[int, int, int]]:
        """(offset, real_len, bucket) pieces covering prompt[start:
        start+count]. A bucket-padded write must never cross max_seq (a
        clamped write would land on earlier rows), so near the cache end
        the pieces fall back to single tokens."""
        buckets = sorted(self.cfg.usable_buckets())
        S = self.cfg.max_seq
        pieces = []
        pos, left = start, count
        while left > 0:
            b = buckets[-1] if left >= buckets[-1] else self.cfg.bucket_for(left)
            if pos + b > S:
                b = 1
            take = min(left, b)
            pieces.append((pos, take, b))
            pos += take
            left -= take
        return pieces

    def _piece_args(self, slot_idx: int, prompt: list[int], off: int, take: int,
                    b: int) -> tuple:
        """The extend programs' leading operands for prompt[off:off+take]
        padded to b tokens at rows [off, off+b) of a slot. Paged pool: the
        piece's pages are made exclusive first."""
        toks = np.zeros((1, b), np.int32)
        toks[0, :take] = prompt[off:off + take]
        pos = (off + np.arange(b, dtype=np.int32))[None, :]
        self._prepare_slot_write(slot_idx, off, off + b)
        return (self.params, self._ck, self._cv,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos).to(self.device), self._dp.local(slot_idx),
                self._scalar(off, torch.int32))

    def _chunked_extend(self, slot_idx: int, prompt: list[int], reuse: int,
                        sp: SamplingParams, request: Optional[Request] = None):
        """Incremental prefill of prompt[reuse:] against the slot's
        resident (or seeded) rows; only the last piece samples. The pieces
        run on the slot's dp shard; every shard books their pages."""
        pieces = self._extend_pieces(reuse, len(prompt) - reuse)
        rid = request.request_id if request is not None else ""
        li = self._dp.local(slot_idx)
        for off, take, b in pieces[:-1]:
            args = self._piece_args(slot_idx, prompt, off, take, b)
            t0, start = time.monotonic(), None
            if li is not None:
                start = self._program_start()
                self._extend_nosample_fn(*args)
            self._note_piece(rid, take, b, t0, start)
        off, take, b = pieces[-1]
        args = self._piece_args(slot_idx, prompt, off, take, b)
        t0, start = time.monotonic(), None
        first_tok = None
        if li is not None:
            start = self._program_start()
            first_tok, new_kd = self._extend_fn(*args, take - 1,
                                                *self._sampler_args(slot_idx, sp),
                                                *self._grammar_args(request, sp))
            self._key_data[li] = new_kd
        self._note_piece(rid, take, b, t0, start)
        self.metrics["extend_steps"] += len(pieces)
        return self._first_token(first_tok, slot_idx)

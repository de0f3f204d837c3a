"""Decode scheduler (port of ``omnia_tpu/engine/scheduler.py``).

Each step applies queued session releases and imports, places the first
waiting request that can take a slot, then decodes all active slots.
With ``prefill_chunk_tokens > 0`` the step is the token-budget policy of
engine/interleave.py instead, and with ``spec_decode > 0`` a step whose
greedy slots have proposals verifies them (engine/spec_decode.py). Up to
``decode_pipeline`` chunks stay in flight: chunk N+1 is enqueued before
chunk N's tokens are read. PyTorch launches are asynchronous, so the
analog of reading a JAX future is a copy of the chunk's ``[K, B]`` tokens
into pinned host memory, enqueued right after the chunk, and a CUDA
event to wait on when the tokens are needed; the wait never covers
chunks enqueued later. While requests queue, the pipeline drains and
single steps are taken so a waiting prefill never sits out a full chunk.

With ``watchdog_s`` set, that wait runs on the engine's one drainer
thread (devloop.py) and the engine thread waits for it with a timeout: a
read that outlives ``watchdog_s`` raises :class:`WatchdogTimeout`, and the
loop's recovery fails the requests in flight and reallocates the device
state, so a hung device bounds a client's wait.

With ``decode_ring >= 2`` (engine/devloop.py) the decode chunks are the
ring edition, replayed as captured graphs on the card (graphs.py): each
dispatch carries a per-slot deadline-step budget, so a deadline finishes
a slot mid-chunk, and a chunk whose batch is done skips the rest of its
steps (``early_exit_steps``). A chunk's read starts on the drainer thread
at dispatch while the ring's self-gate allows it (``ring_drains``), and a
pipeline holding ``capacity`` unread chunks reads its oldest before the
next one is enqueued (``ring_full_stalls``). Mixed steps ride the same
pipeline.

Under data parallelism each rank's chunk runs over its shard's slots, and
one all-gather over dp per chunk joins the shards' ``[K, num_slots //
dp]`` tokens into the ``[K, num_slots]`` every rank's books read: after
the program, or after the graph's replay (outside the graph; on NCCL
enqueued behind it). The decode ring's deadline-step budget is reckoned
for every slot and each shard's chunk takes its own block of it.
"""

from __future__ import annotations

import queue
import time
from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch.engine.faults import WatchdogTimeout
from omnia_tpu_torch.engine.graphs import NO_DEADLINE
from omnia_tpu_torch.engine.types import FinishReason, SamplingParams, StreamEvent
from omnia_tpu_torch.utils.timeline import recording


class _InflightChunk:
    """A dispatched decode chunk whose tokens have not been read yet.

    ``active`` is the (slot, request_id) snapshot at dispatch and
    ``dispatch_s`` the host's enqueue wall. Ring extras: ``dl_steps``
    mirrors the deadline-step budget the chunk was given (the host must
    finish a slot at the step the device masked it) and ``entry`` the
    drainer's handle when the read started at dispatch. ``timing`` is the
    decode chunk's event pair and stamps with the flight recorder on
    (``utils/timeline.py``): its stamps' copy rides the tokens' event."""

    __slots__ = ("toks", "host", "event", "active", "dispatch_s", "dl_steps", "entry",
                 "timing")

    def __init__(self, toks: torch.Tensor, active: list, dispatch_s: float,
                 dl_steps: Optional[np.ndarray] = None, timing=None):
        self.toks = toks
        self.active = active
        self.dispatch_s = dispatch_s
        self.dl_steps = dl_steps
        self.timing = timing
        self.entry = None
        self.host: Optional[torch.Tensor] = None
        self.event = None
        if toks.is_cuda:
            self.host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            self.host.copy_(toks, non_blocking=True)
            if timing is not None:
                timing.copy_out()
            self.event = torch.cuda.Event()
            self.event.record()

    def read(self) -> np.ndarray:
        """The tokens [K, B] on the host, waiting for the chunk's copy.
        The CUDA event's wait releases the interpreter lock, so the
        drainer thread can block here while the engine thread's timed
        wait runs."""
        if self.event is None:
            return self.toks.numpy()
        self.event.synchronize()
        return self.host.numpy()


class _SchedulerMixin:
    """Step-loop and pipeline methods of :class:`InferenceEngine`."""

    def generate(self, prompt_tokens: list[int],
                 params: SamplingParams = SamplingParams()) -> tuple[list[int], StreamEvent]:
        """Submit and wait: steps the engine inline when no engine thread
        runs, else blocks on the stream. Returns (tokens, final event)."""
        handle = self.submit(prompt_tokens, params)
        if self._thread is None:
            toks: list[int] = []
            while True:
                self.step()
                try:
                    while True:
                        ev = handle._queue.get_nowait()
                        if ev.token_id is not None:
                            toks.append(ev.token_id)
                        if ev.is_final:
                            return toks, ev
                except queue.Empty:
                    pass
        return handle.collect_tokens(timeout=120)

    def live_request_ids(self) -> set:
        """Request ids still queued or decoding."""
        with self._lock:
            waiting = {req.request_id for req, _h in self._waiting}
        pf = self._prefilling
        if pf is not None:
            waiting.add(pf.request.request_id)  # mid-interleave placement
        return waiting | {s.request.request_id for s in self._slots if s.active}

    def _push_final(self, handle, rid: str, reason: FinishReason, **fields) -> None:
        """Push a request's terminal event, its reason mapped by value
        into the caller's enum class (``finish_reasons``), so that the
        JAX package's runtime and coordinator recognise it."""
        handle._push(StreamEvent(rid, finish_reason=self._finish_reasons(reason.value),
                                 **fields))

    def step(self) -> bool:
        """One scheduling step. Returns True if any work was done."""
        self._drain_releases()
        self._drain_imports()
        self._drain_prefix_regs()
        self._reap_cancelled()
        self._reap_deadlines()
        if self._mixed_enabled():
            return self._step_mixed()
        did = False
        with self._lock:
            queued = bool(self._waiting)
        if queued and self._inflight:
            # Surface in-flight finishes now so their slots free up.
            self._flush_pipeline()
            did = True
        pending, slot_idx = self._claim_pending()
        if pending is not None:
            self._place_pending(slot_idx, *pending)
            did = True
        if any(s.active for s in self._slots):
            with self._lock:
                queued = bool(self._waiting)
            # Greedy slots verify their proposals while the others take
            # the exact decode step in the same enqueue; the plan falls
            # through to the plain lane when speculation would not pay.
            if self._spec_step():
                return True
            if self._inflight and not self._dispatch_ahead_useful():
                self._process_oldest_chunk()
            else:
                self._dispatch_decode(single=queued)
                depth = 1 if queued else max(1, self.cfg.decode_pipeline)
                while len(self._inflight) >= depth:
                    self._process_oldest_chunk()
            did = True
        elif self._inflight:
            self._process_oldest_chunk()
            did = True
        return did

    def _claim_pending(self):
        """Claim the first waiting request that can be placed now: a turn
        whose session still decodes must not hold up the requests behind
        it. The claim leaves the queue and ``_placing`` counts it until
        placement ends. Returns ``(pending, slot_idx)`` or ``(None, None)``."""
        with self._lock:
            waiting = list(self._waiting)
        for cand in self._admission_order(waiting):
            # May offload an idle session to free its slot: outside the
            # lock, since the copy waits on the device.
            slot_idx = self._slot_for(cand[0])
            if slot_idx is not None:
                break
        else:
            return None, None
        with self._lock:
            try:
                self._waiting.remove(cand)
            except ValueError:
                return None, None  # reaped meanwhile
            self._placing += 1
        if self._flight is not None:
            self._flight.note_claim(cand[0].request_id)
        return cand, slot_idx

    # Requests older than this keep strict FIFO priority whatever their
    # estimated prefill; the estimate is taken over the queue's head only.
    _ADMIT_FAIRNESS_S = 0.5
    _ADMIT_WINDOW = 8

    def _admission_order(self, waiting):
        """With the prefix pool on, place the cheapest estimated prefill
        first among the queue's young head: a fresh session mostly covered
        by the pool costs a seed and a short suffix."""
        if len(waiting) < 2 or not self._prefix_enabled() or self.clock is not time.monotonic:
            # An injected clock keeps the submit order, as in the JAX engine.
            return waiting
        now = time.monotonic()  # Request.submitted_at's clock
        head = waiting[:self._ADMIT_WINDOW]

        def key(item):
            idx, (req, _h) = item
            if now - req.submitted_at >= self._ADMIT_FAIRNESS_S:
                return (0, idx, 0)
            return (1, self._estimated_prefill_cost(req), idx)

        ordered = [it for _, it in sorted(enumerate(head), key=key)]
        return ordered + waiting[self._ADMIT_WINDOW:]

    def _estimated_prefill_cost(self, req) -> int:
        """Tokens the request would prefill: its prompt less the better of
        its session's resident-row LCP and the pool's match."""
        prompt = req.prompt_tokens
        covered = self._prefix_match_len(prompt)
        if req.session_id and self.cfg.max_sessions > 0:
            sess = self._sessions.get(req.session_id)
            if sess is not None:
                lcp, limit = 0, min(len(sess.token_ids), len(prompt) - 1)
                while lcp < limit and sess.token_ids[lcp] == prompt[lcp]:
                    lcp += 1
                covered = max(covered, lcp)
        return len(prompt) - min(covered, len(prompt) - 1)

    def _place_pending(self, slot_idx, request, handle):
        try:
            self._place_request(slot_idx, request, handle)
        except Exception:
            self._fail_placement(slot_idx, request, handle, "prefill failed")
            raise
        finally:
            with self._lock:
                self._placing -= 1

    def _fail_placement(self, slot_idx, request, handle, msg: str):
        # A nonzero prompt count marks an accepted request: the
        # coordinator resubmits such an ERROR elsewhere.
        self._push_final(handle, request.request_id, FinishReason.ERROR, error=msg,
                         num_prompt_tokens=len(request.prompt_tokens))
        self.metrics["requests_finished"] += 1
        if self._flight is not None:
            self._flight.note_terminal(request.request_id, FinishReason.ERROR.value, error=msg)
        self._drop_session(request.session_id)
        self._slots[slot_idx].session_id = None
        self._release_slot_seed(self._slots[slot_idx])
        self._slots[slot_idx].clear()

    def _dispatch_ahead_useful(self) -> bool:
        """True if some active slot's budget extends past the steps
        already in flight (stop ids are unpredictable, so optimistic)."""
        return self._remaining_work() > 0

    def _reap_cancelled(self):
        for i, slot in enumerate(self._slots):
            if slot.active and slot.handle.cancelled:
                self._finish_slot(i, FinishReason.CANCELLED)
        pf = self._prefilling
        if pf is not None and pf.handle.cancelled:
            self._abort_prefilling(FinishReason.CANCELLED)
        reaped = []
        with self._lock:
            still = []
            for req, handle in self._waiting:
                if handle.cancelled:
                    self._push_final(handle, req.request_id, FinishReason.CANCELLED)
                    self.metrics["requests_finished"] += 1
                    reaped.append(req.request_id)
                else:
                    still.append((req, handle))
            self._waiting = still
        if self._flight is not None:
            # A terminal ends the request's span (tracer I/O): never
            # under the engine lock.
            for rid in reaped:
                self._flight.note_terminal(rid, FinishReason.CANCELLED.value)

    def _reap_deadlines(self):
        """Queued requests past their deadline shed with DEADLINE; active
        ones finish early with their partial output (chunk granularity)."""
        now = self.clock()
        for i, slot in enumerate(self._slots):
            if (slot.active and slot.request.deadline_at is not None
                    and now >= slot.request.deadline_at):
                self.metrics["deadline_exceeded"] += 1
                self._finish_slot(i, FinishReason.DEADLINE)
        pf = self._prefilling
        if (pf is not None and pf.request.deadline_at is not None
                and now >= pf.request.deadline_at):
            # Mid-prefill: the consumed pieces were counted as they ran
            # and their rows stay valid for the session.
            self.metrics["deadline_exceeded"] += 1
            self._abort_prefilling(FinishReason.DEADLINE)
        reaped = []
        with self._lock:
            still = []
            for req, handle in self._waiting:
                if req.deadline_at is not None and now >= req.deadline_at:
                    self._push_final(handle, req.request_id, FinishReason.DEADLINE,
                                     num_prompt_tokens=len(req.prompt_tokens))
                    self.metrics["deadline_exceeded"] += 1
                    self.metrics["requests_finished"] += 1
                    reaped.append(req.request_id)
                else:
                    still.append((req, handle))
            self._waiting = still
        if self._flight is not None:
            for rid in reaped:
                self._flight.note_terminal(rid, FinishReason.DEADLINE.value)

    def _fault_sleep_s(self) -> float:
        """Injected hang / slow-sync seconds for the next chunk read
        (faults.py), taken where the read starts: inline, or on the
        drainer thread, where a hang looks to the watchdog exactly like a
        hung device."""
        fault = self._fault_plan
        if fault is None:
            return 0.0
        return fault.take_hang_s() + fault.slow_sync_s

    def _sync_chunk_host(self, ch: _InflightChunk) -> np.ndarray:
        """A decode chunk's tokens on the host. Without ``watchdog_s`` and
        without a drain entry the read is the direct wait, on this thread.
        Otherwise it rides the engine's one drainer thread: a read started
        at dispatch (``ch.entry``) is awaited, a watchdog-only read is
        handed over now. A read that outlives ``watchdog_s`` counts a
        trip, marks the engine unhealthy and raises WatchdogTimeout (the
        loop's recovery takes it)."""
        wd = self.cfg.watchdog_s
        entry = ch.entry
        if entry is None:
            if wd is None:
                sleep_s = self._fault_sleep_s()
                if sleep_s > 0.0:
                    time.sleep(sleep_s)
                return ch.read()
            entry = self._devloop.get_drainer().submit(ch.read,
                                                       pre_sleep_s=self._fault_sleep_s())
        host = self._devloop.get_drainer().wait(entry, timeout=wd)
        if host is None:
            self.metrics["watchdog_trips"] += 1
            self._healthy = False  # until recovery has reallocated
            raise WatchdogTimeout(f"decode chunk host sync exceeded watchdog_s={wd}")
        return host

    def _adopt_decode_state(self, out) -> None:
        """Take a program's outputs (ck, cv, tokens, positions, active,
        budget, key_data[, gstate]) as the engine's decode state: rebound,
        or, while captured graphs point at the state tensors, copied into
        them in place. The caches were written in place already."""
        names = ("_tokens", "_positions", "_active", "_budget", "_key_data")
        for name, value in zip(names + (("_gstate",) if self._gr_on else ()), out[2:]):
            if self._ring_graphs is None:
                setattr(self, name, value)
            elif getattr(self, name) is not value:
                getattr(self, name).copy_(value)

    def _run_decode_step(self, chunk: int, dl_steps: Optional[np.ndarray] = None):
        """Enqueue one decode chunk; device state advances to its outputs
        at once. Returns its tokens [K, B] (every dp shard's), unread. The
        ring edition takes the deadline-step budget ``dl_steps`` (every
        slot's; the shard runs its block) and, with the grammar, the
        per-slot grammar EOS; on the card it replays the chunk's graph."""
        t_dispatch = time.monotonic()
        graphs = self._ring()
        if dl_steps is not None:
            dl_steps = dl_steps[self._dp.lo:self._dp.hi]    # this shard's slots
        tl, timing = self._timeline, None
        if tl is not None:
            # The stamps land in the graph's own buffer, or in a fresh one
            # for the eager chunk.
            timing = tl.begin_chunk(graphs.stamps(chunk) if graphs is not None
                                    else tl.stamps_for(chunk))
        if graphs is not None:
            toks = self._dp.gather(graphs.replay(chunk, dl_steps), dim=1)
        else:
            ring_args = ()
            if self.cfg.decode_ring > 0:
                ring_args = (((self._geos,) if self._gr_on else ())
                             + (torch.from_numpy(dl_steps).to(self.device),))
            with recording(timing.stamps if timing is not None else None):
                out = self._decode_fns[chunk](
                    self.params, self._ck, self._cv, self._tokens, self._positions,
                    self._active, self._budget, self._stop_ids, self._key_data,
                    self._temp, self._top_p, self._top_k,
                    *((self._gstate, self._gtable, self._gactive) if self._gr_on else ()),
                    *ring_args,
                )
            # The ring's deadline carry (before toks) is dropped: the next
            # dispatch computes the budget afresh.
            self._adopt_decode_state(out)
            toks = self._dp.gather(out[-1], dim=1)
        if timing is not None:
            tl.end_chunk(timing, toks)
        self.metrics["decode_dispatch_s"] += time.monotonic() - t_dispatch
        self.metrics["decode_steps"] += int(toks.shape[0])
        return toks

    def _remaining_work(self) -> int:
        """Max over active slots of tokens still to emit beyond the steps
        already in flight."""
        inflight_steps: dict[int, int] = {}
        for ch in self._inflight:
            k = int(ch.toks.shape[0])
            for i, _rid in ch.active:
                inflight_steps[i] = inflight_steps.get(i, 0) + k
        need = 0
        for i, s in enumerate(self._slots):
            if not s.active:
                continue
            rem = min(
                s.max_total - s.generated, self.cfg.max_seq - 2 - s.length,
            ) - inflight_steps.get(i, 0)
            need = max(need, rem)
        return need

    def _pick_chunk(self) -> int:
        """The full chunk while work exceeds it, else the smallest variant
        covering the remainder (overshot steps are masked on the device)."""
        need = max(self._remaining_work(), 1)
        best = max(self._decode_fns)
        for k in sorted(self._decode_fns):
            if k >= need:
                best = k
                break
        return best

    def _dispatch_decode(self, single: bool = False):
        active = [
            (i, s.request.request_id) for i, s in enumerate(self._slots) if s.active
        ]
        chunk = 1 if single else self._pick_chunk()
        # Paged pool: extend every active slot's pages past its write
        # frontier before the chunk is enqueued (engine/paged.py); a
        # decode write must never land through a trash table entry.
        self._prealloc_decode_pages(chunk)
        dl_steps = self._deadline_steps() if self.cfg.decode_ring > 0 else None
        t_dispatch = time.monotonic()
        toks = self._run_decode_step(chunk, dl_steps)
        self._push_inflight(toks, active, time.monotonic() - t_dispatch, dl_steps)

    def _deadline_steps(self) -> np.ndarray:
        """Per-slot deadline budget in decode steps for the next ring
        dispatch: the wall time left to each slot's deadline over the
        realized per-step EMA (devloop.py), at least 1 (a deadline already
        past is the step-boundary reap's). Slots without a deadline, and
        every slot under an injected clock, get an effectively infinite
        budget."""
        dl = np.full((self.cfg.num_slots,), NO_DEADLINE, np.int32)
        if self.clock is not time.monotonic:
            return dl
        ema = max(self._devloop.step_ema_s, 1e-6)
        now = time.monotonic()
        for i, s in enumerate(self._slots):
            if s.active and s.request.deadline_at is not None:
                steps = int((s.request.deadline_at - now) / ema)
                dl[i] = max(1, min(NO_DEADLINE, steps))
        return dl

    def _push_inflight(self, toks, active, dispatch_s: float, dl_steps=None) -> None:
        """Append one dispatched chunk to the pipeline: the one seam of
        decode chunks and mixed steps (both ride the ring). With async
        drain engaged the read starts now on the drainer thread, and a
        ring already holding ``capacity`` unread chunks processes its
        oldest first (ring_full_stalls)."""
        timing = self._timeline.take(toks) if self._timeline is not None else None
        ch = _InflightChunk(toks, active, dispatch_s, dl_steps, timing)
        dv = self._devloop
        if dv is not None and dv.async_engaged(self.clock is time.monotonic):
            if len(self._inflight) >= dv.capacity:
                self.metrics["ring_full_stalls"] += 1
                self._process_oldest_chunk()
            ch.entry = dv.get_drainer().submit(ch.read, pre_sleep_s=self._fault_sleep_s(),
                                               on_drained=self._note_ring_drain)
        self._inflight.append(ch)

    def _note_ring_drain(self, host_tokens, drain_s: float) -> None:
        """Drainer-thread callback: the drain as its own flight event, so
        that the wait is booked to the thread that blocked on it. A failed
        read (None) records nothing: the engine thread re-raises."""
        if self._flight is not None and host_tokens is not None:
            self._flight.note_ring_drain(1, int(host_tokens.size), drain_s)

    def _process_oldest_chunk(self):
        ch = self._inflight.popleft()
        t_sync = time.monotonic()
        host_tokens = self._sync_chunk_host(ch)  # [K, B]
        sync_s = time.monotonic() - t_sync
        self.metrics["decode_sync_s"] += sync_s
        drained = ch.entry is not None
        if drained:
            self.metrics["ring_drains"] += 1
        K = int(host_tokens.shape[0])
        dv = self._devloop
        if dv is not None and K > 0:
            # The realized per-step wall feeds the deadline-step EMA.
            dv.observe_step_time((ch.dispatch_s + sync_s) / K)
        if self._flight is not None:
            timeline = None
            if ch.timing is not None:
                timeline = self._timeline.resolve(ch.timing, self.metrics)
            self._flight.note_decode_chunk(K, ch.dispatch_s, sync_s, len(ch.active),
                                           drained=drained, timeline=timeline)
        for k in range(K):
            stepped = False
            for i, rid in ch.active:
                slot = self._slots[i]
                if not slot.active or slot.request.request_id != rid:
                    # Finished earlier in this chunk, or re-placed since.
                    continue
                if ch.dl_steps is not None and k >= int(ch.dl_steps[i]):
                    # The device masked this slot at exactly this step:
                    # finish with the partial output.
                    self.metrics["deadline_exceeded"] += 1
                    self._finish_slot(i, FinishReason.DEADLINE)
                    continue
                stepped = True
                slot.length += 1
                self._emit_token(i, int(host_tokens[k, i]))
            if not stepped:
                # Every snapshot slot is done: the rest of the chunk is
                # frozen tokens, and a ring chunk (dl_steps rides only
                # those) skipped those steps on the device.
                if ch.dl_steps is not None:
                    self.metrics["early_exit_steps"] += K - k
                break
        if (self._timeline is not None and not self._inflight
                and not any(s.active for s in self._slots)):
            self._timeline.idle()
        if dv is not None and dv.gate is not None and self.clock is time.monotonic:
            # One gate tick per processed chunk; skipped under an injected
            # clock, where a wall-clock decision could diverge replicas.
            dv.gate.tick(time.monotonic(), self.metrics["tokens_generated"])
            self.metrics["decode_ring_gate_state"] = dv.gate.state_code()

    def _flush_pipeline(self):
        while self._inflight:
            self._process_oldest_chunk()

    def _emit_token(self, slot_idx: int, token: int):
        slot = self._slots[slot_idx]
        if not slot.active:
            return
        if slot.gr_view is not None:
            # Host mirror of the device FSM walk: the state before this
            # token is what the sampler masked with.
            self._gr_mask_sum += slot.gr_view.masked_fraction(slot.gr_state)
            self._gr_mask_steps += 1
            self.metrics["masked_logit_fraction"] = round(
                self._gr_mask_sum / self._gr_mask_steps, 6)
            nxt = slot.gr_view.advance(slot.gr_state, token)
            if nxt >= 0:
                slot.gr_state = nxt
        if token in slot.stop_ids:
            self._finish_slot(slot_idx, FinishReason.STOP)
            return
        slot.generated += 1
        slot.emitted.append(token)
        slot.handle._push(StreamEvent(slot.request.request_id, token_id=token))
        self.metrics["tokens_generated"] += 1
        # The cache bound stops a step early so the next decode write
        # stays legal (row max_seq - 1 is the last one).
        if slot.generated >= slot.max_total or slot.length >= self.cfg.max_seq - 2:
            self._finish_slot(slot_idx, FinishReason.LENGTH)

    def _finish_slot(self, slot_idx: int, reason: FinishReason):
        slot = self._slots[slot_idx]
        rid = slot.request.request_id
        handle = slot.handle
        n_prompt = len(slot.request.prompt_tokens)
        generated = slot.generated
        if slot.gr_view is not None:
            # A constrained generation brought to a valid stop.
            if reason is FinishReason.STOP and slot.gr_view.is_accepting(slot.gr_state):
                self.metrics["grammar_rejections_avoided"] += 1
            if self._dp.local(slot_idx) is not None:
                self._gactive[self._dp.local(slot_idx)] = False
        # Sessionful: record which rows the next turn may reuse, BEFORE the
        # terminal event is observable. The last emitted token's row is
        # written only if another decode step ran, so it is left out. The
        # slot then parks at that frontier, so the frozen row's garbage
        # lands only at rows >= the session's length.
        quiesce_row = 0
        sess = self._sessions.get(slot.session_id) if slot.session_id else None
        if sess is not None:
            sess.token_ids = list(slot.request.prompt_tokens) + slot.emitted[:-1]
            sess.last_used = self.clock()
            quiesce_row = len(sess.token_ids)
        self._release_slot_seed(slot)
        slot.clear()
        # Paged pool: pages past the quiesce row (all of them for an
        # unpinned slot) go back to the free list and their table
        # positions to trash, so the frozen row's writes land in the kept
        # partial page or in trash. Chunks still in flight were enqueued
        # before this table write and write through the old row; a page
        # handed out now is written only by work enqueued after them
        # (engine/paged.py).
        self._trim_slot_pages(slot_idx, quiesce_row)
        # Quiesce: decode keeps running over the slot (static batch) but
        # with active False it only rewrites its frozen row: row 0 of an
        # unpinned slot, which the next placement's prefill overwrites
        # (through trash when paged), or the session's frontier.
        li = self._dp.local(slot_idx)
        if li is not None:
            self._positions[li] = quiesce_row
            self._tokens[li] = 0
            self._temp[li] = 0.0
            self._active[li] = False
        self._push_final(handle, rid, reason, num_prompt_tokens=n_prompt,
                         num_generated_tokens=generated)
        self.metrics["requests_finished"] += 1
        if self._flight is not None:
            self._flight.note_terminal(rid, reason.value, tokens=generated,
                                       first_token_at=handle.first_token_at)

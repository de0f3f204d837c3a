"""Prompt-lookup speculative decoding (port of
``omnia_tpu/engine/spec_decode.py``; ``EngineConfig.spec_decode``).

A decode step reads every weight for one token per slot. The verify
window reads them once for W + 1 tokens per slot, so each accepted
proposal is a token for almost nothing; the proposals come from the
slot's own prompt and output (prompt lookup), which tool-call JSON and
quoted context repeat.

- **Per-slot depth.** Each slot proposes up to its own depth; with
  ``spec_decode_max > 0`` an accept-rate EMA moves it between 0 (the
  slot stops proposing, with a 1-token re-probe every ``_RETRY_STEPS``
  plans) and ``spec_decode_max``. The window stays [B, W + 1]
  (W = ``EngineConfig.spec_window()``); depth decides how many of its
  positions hold real proposals.
- **Per-slot lanes.** Greedy slots verify; sampled slots (and slots
  whose first token is not through) take the exact decode step in the
  same enqueue (``verify_decode``), so their tokens and PRNG stream are
  those of the plain engine. While a prompt piece is in flight
  (engine/interleave.py) the window rides the mixed step
  (``mixed_spec``).
- **Grammar.** The oracle is the masked argmax, its FSM state walking
  the proposed stream (programs.py ``_verify_window``).
- **Self-gate.** ``_SpecGate`` alternates windows with speculation
  permitted and suppressed and keeps the faster (``spec_gate_window``).

A verify step is synchronous: acceptance decides the next step's inputs,
so in-flight chunks are read before planning, and the window's greedy
tokens are read right after the enqueue.

The host half (``validate_spec_config``, ``spec_depth_update``,
``_NgramIndex``, ``_SpecGate``, ``_SpecPlan``) is a copy of the JAX
package's: the same inputs give the same outputs.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch.engine.types import EngineConfig

_NGRAM_MAX = 3
#: Entries kept per n-gram order per slot index (bounds host memory on
#: long sessions; see _NgramIndex eviction notes).
_NGRAM_CAP = 4096
#: Documented per-entry host-cost estimate for the ``spec_index_bytes``
#: gauge: key tuple (+ its ints) + dict slot + int value, rounded up.
_ENTRY_BYTES = 120
#: Accept-rate EMA smoothing for the per-slot depth controller.
_EMA_ALPHA = 0.25
#: Below this EMA a slot stops proposing entirely (depth 0) ...
_K_MIN_EMA = 0.125
#: ... and re-probes with a single proposal every this many verify
#: steps, so a slot whose traffic turns repetitive again can recover.
_RETRY_STEPS = 16


def validate_spec_config(ecfg: EngineConfig) -> None:
    """Construction-time validation (engine __init__ delegates here).
    ``spec_decode=0`` turns the whole subsystem off; the other knobs are
    then dead and deliberately unvalidated (the guarded-no-op rule)."""
    if not ecfg.spec_decode:
        return
    usable = ecfg.usable_buckets()
    w = ecfg.spec_window()
    if not usable or w + 1 > min(usable):
        # Rejected-proposal rows at an unpinned idle slot must be
        # covered by the next occupant's smallest prefill write.
        raise ValueError(
            f"spec window {w} (max of spec_decode={ecfg.spec_decode}, "
            f"spec_decode_max={ecfg.spec_decode_max}) needs "
            f"window + 1 <= min(prefill_buckets)"
        )
    if ecfg.spec_decode_max and ecfg.spec_decode_max < ecfg.spec_decode:
        raise ValueError(
            "spec_decode_max must be 0 (fixed depth) or >= spec_decode"
        )
    if ecfg.spec_gate_window < 0:
        raise ValueError("spec_gate_window must be >= 0")


def spec_depth_update(
    ema: float, real: int, accepted: int, kmax: int
) -> tuple[float, int]:
    """One accept-rate observation → (new EMA, new per-slot depth).

    The one depth policy of the per-slot controller: EMA of
    accepted/real; depth rounds the EMA up into
    [1, kmax], or 0 once the EMA falls under the floor (the slot then
    re-probes on the engine's _RETRY_STEPS cadence). kmax <= 0 means
    fixed-depth mode — the EMA still tracks (observability) but depth
    is pinned by the caller."""
    if real > 0:
        ema += _EMA_ALPHA * (accepted / real - ema)
    if kmax <= 0:
        return ema, 0
    if ema < _K_MIN_EMA:
        return ema, 0
    return ema, max(1, min(kmax, int(ema * kmax + 0.5)))


class _NgramIndex:
    """Incremental most-recent-occurrence index over an append-only
    token sequence: maps each n-gram (n = 1.._NGRAM_MAX) to the latest
    start position strictly BEFORE the current tail.

    Host memory is BOUNDED: each order keeps at most ``_NGRAM_CAP``
    entries, evicted least-recently-INGESTED first: a re-seen gram is
    re-inserted at the back of the dict's insertion order (delete +
    insert, O(1)), so the grams that keep recurring — prompt-lookup's
    highest-value hits — survive, and eviction drops grams the context
    never revisited. The RECENT context therefore stays fully indexed,
    which is where hits live."""

    __slots__ = ("maps", "built")

    def __init__(self):
        self.maps = {n: {} for n in range(1, _NGRAM_MAX + 1)}
        self.built = {n: 0 for n in range(1, _NGRAM_MAX + 1)}

    def entries(self) -> int:
        return sum(len(m) for m in self.maps.values())

    def propose(self, ctx: list[int], k: int) -> tuple[list[int], int]:
        """(k proposals zero-padded, number of REAL proposals)."""
        L = len(ctx)
        for n in range(min(_NGRAM_MAX, L - 1), 0, -1):
            m = self.maps[n]
            # Ingest every start whose gram lies fully before the tail
            # start (L - n); ctx only appends, so this is incremental.
            for i in range(self.built[n], L - n):
                gram = tuple(ctx[i:i + n])
                if gram in m:
                    del m[gram]  # re-insert at the back (recency order)
                elif len(m) >= _NGRAM_CAP:
                    del m[next(iter(m))]  # evict least-recently-ingested
                m[gram] = i
            self.built[n] = max(self.built[n], L - n)
            hit = m.get(tuple(ctx[L - n:]))
            if hit is not None:
                prop = ctx[hit + n:hit + n + k]
                if prop:
                    return prop + [0] * (k - len(prop)), len(prop)
        return [0] * k, 0


class _SpecGate:
    """Online self-gate: duty-cycle probe of realized decode throughput
    with speculation permitted vs suppressed.

    States cycle PROBE_SPEC(window ticks) → PROBE_PLAIN(window) →
    decide → HOLD_ON/HOLD_OFF(window × hold_factor) → re-probe. A tick
    is one scheduler step with live decode; the rate of a phase is
    (tokens generated) / (wall seconds) across it, so the comparison
    prices in EVERYTHING speculation changes — pipeline forfeiture,
    host propose time, verify sync — not just tokens per weight
    stream. Speculation must be at least ``margin`` of the plain rate
    to stay on; re-probing keeps a disable honest when traffic turns
    repetitive later. The engine skips ticking under an injected
    clock, where a wall-clock decision would not be reproducible."""

    PROBE_SPEC, PROBE_PLAIN, HOLD_ON, HOLD_OFF = range(4)
    _NAMES = {PROBE_SPEC: "probe_spec", PROBE_PLAIN: "probe_plain",
              HOLD_ON: "on", HOLD_OFF: "off"}

    def __init__(self, window: int, hold_factor: int = 8,
                 margin: float = 0.98):
        self.window = window
        self.hold_factor = hold_factor
        self.margin = margin
        self.state = self.PROBE_SPEC
        self.ticks = 0
        self.phase_t0: Optional[float] = None
        self.phase_tok0 = 0
        self.rate_spec: Optional[float] = None
        self.rate_plain: Optional[float] = None
        self.decisions = 0
        self.disables = 0

    def allows_spec(self) -> bool:
        return self.state in (self.PROBE_SPEC, self.HOLD_ON)

    def state_code(self) -> int:
        """Stable metric encoding: 0 = probing, 1 = on, 2 = off."""
        if self.state == self.HOLD_ON:
            return 1
        if self.state == self.HOLD_OFF:
            return 2
        return 0

    def tick(self, now: float, tokens: int) -> bool:
        """Advance one scheduler step; returns whether speculation is
        permitted for this step."""
        if self.window <= 0:
            return True
        if self.phase_t0 is None:
            self.phase_t0, self.phase_tok0 = now, tokens
        self.ticks += 1
        probing = self.state in (self.PROBE_SPEC, self.PROBE_PLAIN)
        limit = self.window if probing else self.window * self.hold_factor
        if self.ticks >= limit:
            rate = (tokens - self.phase_tok0) / max(now - self.phase_t0, 1e-9)
            if self.state == self.PROBE_SPEC:
                self.rate_spec = rate
                self.state = self.PROBE_PLAIN
            elif self.state == self.PROBE_PLAIN:
                self.rate_plain = rate
                self.decisions += 1
                if (self.rate_spec or 0.0) >= rate * self.margin:
                    self.state = self.HOLD_ON
                else:
                    self.state = self.HOLD_OFF
                    self.disables += 1
            else:
                # Hold expired: refresh that mode's rate and re-probe.
                if self.state == self.HOLD_ON:
                    self.rate_spec = rate
                else:
                    self.rate_plain = rate
                self.state = self.PROBE_SPEC
            self.ticks = 0
            self.phase_t0, self.phase_tok0 = now, tokens
        return self.allows_spec()

    def report(self) -> dict:
        """Debug snapshot of the gate's state and rates."""
        r = lambda v: None if v is None else round(v, 2)  # noqa: E731
        return {
            "state": self._NAMES[self.state],
            "rate_spec_tok_s": r(self.rate_spec),
            "rate_plain_tok_s": r(self.rate_plain),
            "decisions": self.decisions,
            "disables": self.disables,
        }


class _SpecPlan:
    """One step's speculative participation: the static [B, W+1] verify
    operands plus the host books acceptance needs."""

    __slots__ = ("toks", "pos", "wstart", "vmask", "proposals", "scan")

    def __init__(self, toks, pos, wstart, vmask, proposals, scan):
        self.toks = toks          # [B, W+1] int32: last token + proposals
        self.pos = pos            # [B, W+1] int32 window positions
        self.wstart = wstart      # [B] int32 per-slot write rows
        self.vmask = vmask        # [B] bool: slot rides the verify lane
        self.proposals = proposals  # {slot: (props padded to W, n real)}
        self.scan = scan          # [(slot, request_id)] scan-lane slots


class _SpecDecodeMixin:
    """Speculative-decode methods of :class:`InferenceEngine`."""

    # Engine-thread state, built on first use (spec_decode = 0 never
    # touches it).
    _spec_gate: Optional[_SpecGate] = None
    _spec_ema_global = 0.0

    def _host_row(self, slot) -> int:
        """The row an inactive slot's verify window writes from, from
        host state only: its pinned session's valid frontier, else 0 (the
        rows the slot's decode step already rewrites)."""
        sid = slot.session_id
        if sid:
            sess = self._sessions.get(sid)
            if sess is not None:
                return len(sess.token_ids)
        return 0

    def _spec_engaged(self) -> bool:
        """Config and gate check of the standalone verify step and the
        mixed step; ticks the gate (each caller runs once per step)."""
        if not self.cfg.spec_decode or self._verify_fn is None:
            return False
        if self.cfg.spec_gate_window > 0 and self.clock is time.monotonic:
            if self._spec_gate is None:
                self._spec_gate = _SpecGate(self.cfg.spec_gate_window)
            allowed = self._spec_gate.tick(time.monotonic(), self.metrics["tokens_generated"])
            self.metrics["spec_gate_state"] = self._spec_gate.state_code()
            if not allowed:
                return False
        return True

    def _slot_depth(self, slot) -> int:
        """A slot's proposal budget this step: spec_decode at fixed
        depth, else the EMA-driven depth, with a 1-token re-probe every
        _RETRY_STEPS plans once it has fallen to 0."""
        kmax = self.cfg.spec_decode_max
        if kmax <= 0:
            return self.cfg.spec_decode
        if slot.spec_k == 0:
            slot.spec_cool += 1
            if slot.spec_cool >= _RETRY_STEPS:
                slot.spec_cool = 0
                return 1
            return 0
        return slot.spec_k

    def _propose(self, slot, k: int, width: int) -> tuple[list[int], int]:
        """k proposals for a slot, zero-padded to the window."""
        if k <= 0:
            return [0] * width, 0
        if slot.spec_index is None:
            slot.spec_index = _NgramIndex()
        ctx = slot.request.prompt_tokens + slot.emitted
        prop, real = slot.spec_index.propose(ctx, k)
        return prop + [0] * (width - len(prop)), real

    def _spec_plan(self, park: Optional[dict] = None,
                   depths: Optional[dict] = None) -> Optional[_SpecPlan]:
        """This step's verify participation, or None for the plain lane:
        no slot has a real proposal, or some slot's window would clamp at
        the cache end (a contiguous write's start is clamped to S - T,
        which would land the window on earlier rows).

        ``park`` gives the window row of specific inactive slots: the
        interleave parks the placing slot's garbage window at its piece's
        end. ``depths`` memoises the per-slot depths across the two plan
        calls of one step (before and after the pipeline flush), so a
        collapsed slot's re-probe cooldown advances once per step."""
        cfg = self.cfg
        W = cfg.spec_window()
        B, S = cfg.num_slots, cfg.max_seq
        toks = np.zeros((B, W + 1), np.int32)
        pos = np.zeros((B, W + 1), np.int32)
        wstart = np.zeros((B,), np.int32)
        vmask = np.zeros((B,), bool)
        proposals: dict[int, tuple[list[int], int]] = {}
        scan: list[tuple[int, str]] = []
        total_real = 0
        ar = np.arange(W + 1, dtype=np.int32)
        for i, s in enumerate(self._slots):
            if s.active:
                if s.length + W + 2 > S:
                    return None  # the window or its parked scan row would clamp
                wstart[i] = s.length
                pos[i] = s.length + ar
                if s.request.params.temperature == 0.0 and s.emitted:
                    # Verify lane, grammar slots included. A slot with no
                    # proposal rides it too: its first position is a plain
                    # greedy step.
                    if depths is not None and i in depths:
                        k_i = depths[i]
                    else:
                        k_i = self._slot_depth(s)
                        if depths is not None:
                            depths[i] = k_i
                    prop, real = self._propose(s, k_i, W)
                    vmask[i] = True
                    proposals[i] = (prop, real)
                    toks[i, 0] = s.emitted[-1]
                    toks[i, 1:] = prop
                    total_real += real
                else:
                    # Scan lane: the exact decode step. Its window is
                    # garbage at rows >= its frontier; the step then
                    # writes row `length` with the real token.
                    scan.append((i, s.request.request_id))
            else:
                row = park.get(i) if park else None
                row = self._host_row(s) if row is None else row
                if row + W + 1 > S:
                    return None
                wstart[i] = row
                pos[i] = row + ar
        if total_real == 0:
            return None
        return _SpecPlan(toks, pos, wstart, vmask, proposals, scan)

    def _spec_step(self) -> bool:
        """One speculative step when no prompt piece is in flight; False
        sends the caller down the plain chunk lane. While speculation is
        live the engine decodes one step at a time: a step with proposals
        verifies them, one without probes with a 1-token decode step, so
        the next step can speculate as soon as the stream repeats."""
        if not self._spec_engaged():
            return False
        if not any(s.active and s.request.params.temperature == 0.0 and s.emitted
                   for s in self._slots):
            return False  # nothing can verify
        if self._inflight:
            # Acceptance decides the next step's inputs: read the chunks
            # in flight first, so proposals come from the settled tail.
            self._flush_pipeline()
            if not any(s.active for s in self._slots):
                return True  # the flush finished every slot
        plan = self._spec_plan(depths={})
        if plan is None:
            self._dispatch_decode(single=True)
            self._process_oldest_chunk()
            return True
        self._spec_dispatch(plan)
        return True

    def _plan_tensors(self, plan: _SpecPlan) -> tuple:
        """The plan's operands for this rank's slots (its dp shard's rows;
        the host plans every slot)."""
        dev, lo, hi = self.device, self._dp.lo, self._dp.hi
        return tuple(torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)
                     for a in (plan.toks, plan.pos, plan.wstart, plan.vmask))

    def _prepare_verify_pages(self) -> None:
        """Paged pool: every active slot's window rows get owned pages
        before the enqueue, the scan lane's garbage windows too (a freed
        page may hold another slot's rows). An idle slot's window writes
        only garbage, into its kept partial page or the trash page."""
        W = self.cfg.spec_window()
        for i, s in enumerate(self._slots):
            if s.active:
                self._prepare_slot_write(i, s.length, min(s.length + W + 1, self.cfg.max_seq))

    def _spec_dispatch(self, plan: _SpecPlan) -> None:
        """One verify enqueue, then acceptance and emission. A batch
        without scan-lane slots runs the bare ``verify``; one with them
        ``verify_decode``."""
        self._prepare_verify_pages()
        gargs = (self._gstate, self._gtable, self._gactive) if self._gr_on else ()
        t_dispatch = time.monotonic()
        dtoks = None
        if plan.scan:
            out = self._verify_decode_fn(
                self.params, self._ck, self._cv, self._tokens, self._positions, self._active,
                self._budget, self._stop_ids, self._key_data, self._temp, self._top_p,
                self._top_k, *self._plan_tensors(plan), *gargs)
            self._adopt_decode_state(out)
            dtoks, greedy = self._dp.gather(out[-2], dim=1), out[-1]
        else:
            toks, pos, wstart, _vmask = self._plan_tensors(plan)
            greedy = self._verify_fn(self.params, self._ck, self._cv, toks, pos, wstart, *gargs)
        greedy = self._dp.gather(greedy, dim=0)
        dispatch_s = time.monotonic() - t_dispatch
        self.metrics["decode_dispatch_s"] += dispatch_s
        t_sync = time.monotonic()
        g = greedy.cpu().numpy()  # [B, W+1]; waits for the enqueue
        host_toks = dtoks.cpu().numpy() if dtoks is not None else None
        sync_s = time.monotonic() - t_sync
        self.metrics["decode_sync_s"] += sync_s
        self.metrics["spec_steps"] += 1
        if dtoks is not None:
            self.metrics["decode_steps"] += 1
        self._spec_accept(plan, g, dispatch_s, sync_s)
        if host_toks is not None:
            # The scan lane's emission: the chunk reader's loop at K = 1.
            for i, rid in plan.scan:
                slot = self._slots[i]
                if not slot.active or slot.request.request_id != rid:
                    continue
                slot.length += 1
                self._emit_token(i, int(host_toks[0, i]))

    def _spec_accept(self, plan: _SpecPlan, g: np.ndarray, dispatch_s: float,
                     sync_s: float) -> None:
        """Acceptance and emission for the verify lane: the proposal
        prefix the oracle agrees with, then the oracle's next token; then
        the per-slot depth and EMA updates and the books. The enqueue and
        wait seconds go to the flight recorder."""
        W = self.cfg.spec_window()
        step_prop = step_acc = 0
        for i, (prop, real) in plan.proposals.items():
            s = self._slots[i]
            if not s.active:
                continue
            accepted = 0
            while accepted < W and prop[accepted] == g[i, accepted]:
                accepted += 1
            # With a grammar, g is the masked argmax along the proposed
            # stream, so every token emitted here is admissible.
            emit = [*prop[:accepted], int(g[i, accepted])]
            # The books count genuine proposals only (a padding zero that
            # matches is still emitted: it is the model's own choice).
            acc_real = min(accepted, real)
            step_prop += real
            step_acc += acc_real
            self.metrics["spec_proposed"] += real
            self.metrics["spec_accepted"] += acc_real
            if real > 0:
                s.spec_ema, new_k = spec_depth_update(s.spec_ema, real, acc_real,
                                                      self.cfg.spec_decode_max)
                if self.cfg.spec_decode_max > 0:
                    s.spec_k = new_k
                self._spec_ema_global += _EMA_ALPHA * (acc_real / real - self._spec_ema_global)
                self.metrics["spec_accept_ema"] = round(self._spec_ema_global, 4)
            # Length before each emission, as the chunk reader does; a
            # stop or the budget can finish the slot mid-list.
            for tok in emit:
                s.length += 1
                self._emit_token(i, int(tok))
                if not s.active:
                    break
            if s.active:
                # The device state follows the host frontier, so a later
                # chunk continues from it (the device budget is not
                # decremented: it only over-allows, and the host's finish
                # check fires first).
                li = self._dp.local(i)
                if li is not None:
                    self._tokens[li] = int(s.emitted[-1])
                    self._positions[li] = s.length
                    if s.gr_view is not None and emit:
                        # _emit_token advanced the host FSM mirror; the
                        # device state advances only inside a decode step.
                        self._gstate[li] = s.gr_state
        self.metrics["spec_index_bytes"] = _ENTRY_BYTES * sum(
            s.spec_index.entries() for s in self._slots if s.spec_index is not None)
        if self._flight is not None:
            self._flight.note_spec_verify(step_prop, step_acc, dispatch_s, sync_s,
                                          len(plan.proposals))

"""Slot and session-KV bookkeeping (port of
``omnia_tpu/engine/sessions.py``).

A *slot* is one row of the fixed decode batch; a *session* is a
conversation whose KV rows outlive its requests, so that the next turn
prefills only the tokens past its longest common prefix with the rows
already cached. A session is resident in a device slot, paged out to
host RAM (``host_k``/``host_v``, the offload format of
``models/kv_quant.py::kv_host``), or empty. The engine thread owns every
structure here; ``release_session`` and ``import_session`` from other
threads are queued under the engine lock and applied at the next step.

Under tensor parallelism a rank's host rows hold its own KV heads
(``[L, R, Hkv / tp, D]``): offload and restore move them as they are. An
export payload carries every head, in the JAX engine's format, so one
taken at tp = 2 imports at tp = 1 and back: ``export_session`` gathers
the heads over the ranks (a collective: every rank exports the session
together) and ``import_session`` keeps this rank's slice.

Under data parallelism a session's host rows are sent over dp on
offload: the slot's owner shard reads them and broadcasts them, so every
rank holds the same host rows (its tp slice of the heads), and a later
turn may restore them into a slot of any shard, written by that slot's
owner. Every rank therefore exports the same payload too; the leader's
is the one a caller reads.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from omnia_tpu_torch.engine.types import Request, RequestHandle, SessionExport
from omnia_tpu_torch.models.kv_quant import as_quant_kv, kv_device, kv_host, kv_map
from omnia_tpu_torch.parallel.collectives import all_gather


class _Slot:
    __slots__ = ("request", "handle", "length", "generated", "max_total",
                 "stop_ids", "session_id", "emitted", "spec_index", "spec_ema",
                 "spec_k", "spec_cool", "seeded_from", "gr_view", "gr_state")

    def __init__(self):
        self.request: Optional[Request] = None
        self.handle: Optional[RequestHandle] = None
        self.length = 0          # tokens currently in the slot's KV rows
        self.generated = 0
        self.max_total = 0       # generation cap (request max_tokens)
        self.stop_ids: frozenset[int] = frozenset()
        self.session_id: Optional[str] = None  # pinned session (may be idle)
        self.emitted: list[int] = []
        # Speculative decoding (spec_decode.py): the request's n-gram
        # index (built on first use), the accept-rate EMA, the proposal
        # depth it drives and the re-probe cooldown once that depth is 0.
        self.spec_index = None
        self.spec_ema = 0.0
        self.spec_k = 0
        self.spec_cool = 0
        # Shared-prefix entry a sessionless request seeded from: pins it
        # until the finish (a session's seed pins through _SessionKV).
        self.seeded_from: Optional[int] = None
        # Grammar: the request grammar's sampler view for this engine's
        # vocab and stop ids, and the host mirror of the device FSM state.
        self.gr_view = None
        self.gr_state = 0

    def clear(self):
        self.request = None
        self.handle = None
        self.length = 0
        self.generated = 0
        self.emitted = []
        self.spec_index = None
        self.spec_ema = 0.0
        self.spec_k = 0
        self.spec_cool = 0
        self.seeded_from = None
        self.gr_view = None
        self.gr_state = 0

    def spec_reset(self, spec_decode: int, spec_decode_max: int) -> None:
        """Arm the depth controller for a newly placed request: depth
        starts at the configured base and the EMA where that depth sits
        on the curve."""
        if spec_decode_max > 0:
            self.spec_k = min(spec_decode, spec_decode_max)
            self.spec_ema = self.spec_k / spec_decode_max
        else:
            self.spec_k = spec_decode
            self.spec_ema = 1.0
        self.spec_cool = 0

    @property
    def active(self) -> bool:
        return self.request is not None


class _SessionKV:
    """A session's KV residency: exactly one of resident (``slot``),
    host-paged (``host_k``) or empty holds. ``token_ids`` are the tokens
    whose rows are known valid: at a finish the last emitted token is
    left out, since its row is written only if another decode step ran."""

    __slots__ = ("session_id", "token_ids", "slot", "host_k", "host_v", "last_used",
                 "seeded_from")

    def __init__(self, session_id: str, now: Optional[float] = None):
        self.session_id = session_id
        self.token_ids: list[int] = []
        self.slot: Optional[int] = None
        # [L, R, Hkv, D] host rows (a QuantKV of numpy leaves under kv_quant).
        self.host_k: Optional[np.ndarray] = None
        self.host_v: Optional[np.ndarray] = None
        self.last_used = time.monotonic() if now is None else now
        # Shared-prefix entry this session seeded from: pinned for the
        # session's lifetime.
        self.seeded_from: Optional[int] = None


class _SessionMixin:
    """Session-residency methods of :class:`InferenceEngine`: slot pick,
    LRU offload to host, restore, the session cap, export and import."""

    def _slot_for(self, request: Request) -> Optional[int]:
        """The slot for a request, or None if it must wait: the session's
        own resident slot (never while its previous turn still decodes
        there), else a free unpinned slot, else the slot of the least
        recently used idle session, offloaded to host first."""
        sid = request.session_id if self.cfg.max_sessions > 0 else None
        if sid is not None:
            sess = self._sessions.get(sid)
            if sess is not None and sess.slot is not None:
                if self._slots[sess.slot].active:
                    return None  # same-session turn still in flight
                return sess.slot
        for i, s in enumerate(self._slots):
            if not s.active and s.session_id is None:
                return i
        idle_pinned = [
            (self._sessions[s.session_id].last_used, i)
            for i, s in enumerate(self._slots)
            if not s.active and s.session_id is not None
            and s.session_id in self._sessions
        ]
        if idle_pinned:
            _, i = min(idle_pinned)
            self._offload_session(self._sessions[self._slots[i].session_id])
            return i
        return None  # every slot is decoding

    def _offload_session(self, sess: _SessionKV) -> None:
        """Copy an idle session's valid rows to host RAM, in its restore
        bucket's row count, and unpin its slot. The copy is ordered on the
        engine's stream after every chunk already enqueued, and waits for
        them; a paged slot's pages go back to the free list. When the
        shared-prefix pool covers every valid row, the copy is elided:
        the session forgets its rows and the next turn seeds from the
        pool."""
        slot_idx = sess.slot
        valid = len(sess.token_ids)
        if valid > 0 and self._prefix_covered(sess.token_ids):
            sess.token_ids = []
            self.metrics["prefix_cache_offload_elisions"] += 1
        elif valid > 0:
            rows = self.cfg.restore_bucket_for(valid)
            k, v = self._slot_rows(slot_idx, rows)
            sess.host_k = kv_host(k)
            sess.host_v = kv_host(v)
            self.metrics["session_offloads"] += 1
            if self._flight is not None:
                self._flight.note_offload(sess.session_id, rows)
        self._free_slot_pages(slot_idx)
        sess.slot = None
        self._slots[slot_idx].session_id = None

    def _restore_session(self, sess: _SessionKV, slot_idx: int) -> None:
        """Copy a host-paged session's rows back into a slot, byte for
        byte (a paged slot gets its pages and table row first); written
        on the slot's dp shard."""
        self._prepare_slot_restore(slot_idx, sess.host_k)
        li = self._dp.local(slot_idx)
        if li is not None:
            self._restore_fn(self._ck, self._cv, kv_device(sess.host_k, self.device),
                             kv_device(sess.host_v, self.device), li)
        sess.host_k = sess.host_v = None
        sess.slot = slot_idx
        self._slots[slot_idx].session_id = sess.session_id
        self.metrics["session_restores"] += 1
        if self._flight is not None:
            self._flight.note_restore(sess.session_id, slot_idx)

    def _drop_session(self, sid: Optional[str]) -> None:
        """Forget a session. An idle slot it held is unpinned and its
        pages freed at once (the JAX engine frees them at the slot's next
        placement); a slot still decoding keeps them until its finish."""
        if not sid:
            return
        sess = self._sessions.pop(sid, None)
        if sess is not None and sess.slot is not None:
            slot = self._slots[sess.slot]
            slot.session_id = None
            if not slot.active:
                self._free_slot_pages(sess.slot)
        if sess is not None:
            self._prefix_decref(sess.seeded_from)

    def release_session(self, session_id: str) -> None:
        """Forget a session's cached rows. Thread-safe: queued and applied
        at the next step; a request still running on it finishes normally."""
        with self._lock:
            self._pending_releases.append(session_id)
        if self._thread is None:
            self._drain_releases()

    def _drain_releases(self) -> None:
        with self._lock:
            released, self._pending_releases = self._pending_releases, []
        for sid in released:
            self._drop_session(sid)

    def export_session(self, session_id: str) -> Optional[SessionExport]:
        """Package one idle session for migration to another engine, in
        the host offload format, and forget it here. Only while the loop
        is stopped (the registry and device state are its); None for an
        unknown or empty session or one whose request still runs."""
        if self._thread is not None:
            return None
        self._drain_releases()
        sess = self._sessions.get(session_id)
        if sess is None:
            return None
        if sess.slot is not None:
            if self._slots[sess.slot].active:
                return None
            self._offload_session(sess)
        if not sess.token_ids or sess.host_k is None:
            return None
        payload = SessionExport(
            session_id=session_id,
            token_ids=list(sess.token_ids),
            host_k=self._all_heads(sess.host_k),
            host_v=self._all_heads(sess.host_v),
            kv_quant=self._kv_quant,
            restore_rows=self.cfg.restore_bucket_for(len(sess.token_ids)),
        )
        self._drop_session(session_id)
        self.metrics["session_exports"] += 1
        return payload

    def import_session(self, export: SessionExport) -> None:
        """Adopt a migrated session: checked now (a ValueError refuses
        it), registered host-paged at the next step (at once while the
        loop is stopped); its next turn restores it like an offload. The
        JAX engine's payloads are taken as they are."""
        export = dataclasses.replace(export, host_k=as_quant_kv(export.host_k),
                                     host_v=as_quant_kv(export.host_v))
        if self.cfg.max_sessions <= 0:
            raise ValueError("engine has sessions disabled (max_sessions=0)")
        if export.kv_quant != self._kv_quant:
            raise ValueError(
                f"kv_quant mismatch: payload {export.kv_quant!r} vs "
                f"engine {self._kv_quant!r}"
            )
        n = len(export.token_ids)
        if n <= 0 or export.host_k is None:
            raise ValueError("empty session payload")
        if n > self.cfg.max_seq - 2:
            raise ValueError(
                f"session of {n} tokens exceeds KV capacity "
                f"(max_seq {self.cfg.max_seq} - 2)"
            )
        rows = self.cfg.restore_bucket_for(n)
        shape = tuple(getattr(export.host_k, "shape", ()) or ())
        mc = self.model_cfg
        expect = (mc.num_layers, rows, mc.num_kv_heads, mc.head_dim)
        if shape != expect:
            raise ValueError(
                f"session KV rows {shape} incompatible with this "
                f"engine's restore shape {expect}"
            )
        export = dataclasses.replace(export, host_k=self._own_heads(export.host_k),
                                     host_v=self._own_heads(export.host_v))
        with self._lock:
            self._pending_imports.append(export)
        if self._thread is None:
            self._drain_imports()

    def _all_heads(self, host):
        """Host rows [L, R, Hkv / tp, D] of every rank → [L, R, Hkv, D] on
        every rank (host rows as they are at tp = 1)."""
        if self._tp is None:
            return host

        def gather(a: np.ndarray) -> np.ndarray:
            # bf16 rows are uint16 bit patterns: gather them as int16.
            wide = a.view(np.int16) if a.dtype == np.uint16 else a
            out = all_gather(torch.from_numpy(np.ascontiguousarray(wide)).to(self.device),
                             self._tp, dim=2).cpu().numpy()
            return out.view(a.dtype)

        return kv_map(gather, host)

    def _own_heads(self, host):
        """This rank's KV heads of full-head host rows (axis 2)."""
        if self._tp is None:
            return host
        n = self.model_cfg.num_kv_heads // self._tp.size
        lo = self._tp.index * n
        return kv_map(lambda a: np.ascontiguousarray(np.asarray(a)[:, :, lo:lo + n]), host)

    def _drain_imports(self) -> None:
        with self._lock:
            imported, self._pending_imports = self._pending_imports, []
        for exp in imported:
            self._drop_session(exp.session_id)  # replace a stale record
            sess = _SessionKV(exp.session_id, now=self.clock())
            sess.token_ids = list(exp.token_ids)
            sess.host_k = exp.host_k
            sess.host_v = exp.host_v
            self._sessions[exp.session_id] = sess
            self.metrics["session_imports"] += 1
            self._enforce_session_cap(protect=exp.session_id)

    def _offload_idle_sessions(self) -> int:
        """Page every idle resident session to host RAM (the tail of
        ``stop(drain=True)``; the loop must not be stepping)."""
        n = 0
        for sess in list(self._sessions.values()):
            if sess.slot is not None and not self._slots[sess.slot].active:
                self._offload_session(sess)
                n += 1
        return n

    def _enforce_session_cap(self, protect: Optional[str] = None) -> None:
        """Drop least-recently-used sessions above max_sessions, never one
        with a decoding request nor ``protect`` (the one being placed)."""
        while len(self._sessions) > self.cfg.max_sessions:
            victims = [
                (s.last_used, s.session_id)
                for s in self._sessions.values()
                if s.session_id != protect
                and not (s.slot is not None and self._slots[s.slot].active)
            ]
            if not victims:
                return
            _, sid = min(victims)
            self._drop_session(sid)

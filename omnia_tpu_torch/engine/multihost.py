"""Lockstep serving: one engine per rank, every rank stepping the same
stream (port of ``omnia_tpu/engine/multihost.py``).

A parallel engine (``EngineConfig`` dp, sp or tp above 1) is one process
per rank of a ``dp x sp x tp`` job, and its steps hold collectives (the
tp reductions, the dp token gather and first-token broadcasts, the sp
ring): all ranks must run the SAME step sequence or the collectives
deadlock. As in the JAX package,
every rank runs identical host control flow on identical inputs:

- Every rank builds the same InferenceEngine over its slice of the model.
- Rank 0 (the leader) owns the public surface: submits, cancels,
  releases and prefix registrations land in an event queue.
- Each tick the leader broadcasts (logical time, events) to every rank
  (``torch.distributed.broadcast``); every rank applies the events to
  its engine and runs ``engine.step()``. The engine's scheduling is
  deterministic given the event stream; the broadcast logical clock
  (``engine.clock``) removes its one wall-clock input (session LRU,
  deadlines).
- Followers' handles stream into the void; only the leader's have
  readers.
- The decode ring (``decode_ring >= 2``) under lockstep: the engine's
  clock is the logical one, so its ring self-gate never binds (async
  drain stays on, ``devloop.async_engaged``) and no slot gets a
  wall-clock deadline budget (``_deadline_steps``): no rank's host reads
  a clock that another rank's does not. The ring's steps hold the tp and
  dp collectives (captured into its graphs on the card), and every rank
  captures them at the same warmup task (``warmup._agree_on_tasks``).

Failure detection: a lost peer wedges every survivor inside a collective
or surfaces as a collective error. After ``tick_timeout_s`` without a
completed tick the monitor marks the engine unhealthy and fails every
live handle, so no client waits past the bound.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from omnia_tpu_torch.engine.types import RequestHandle, SamplingParams, StreamEvent
from omnia_tpu_torch.parallel.collectives import world_comm

logger = logging.getLogger(__name__)

# Two-phase tick broadcast: a fixed 16-byte header every tick, then an
# exact-size payload only when events exist (a collective needs one shape
# per call; the header tells every rank the payload's).
_HDR_BYTES = 16
_MAX_PAYLOAD = 1 << 20          # hard cap: one tick's event JSON
_DRAIN_BUDGET = 48 * 1024       # soft per-tick size; the rest waits


class LockstepEngine:
    """Engine-shaped facade driving the ranks' engines in lockstep.

    Leader: duck-types InferenceEngine for the runtime (submit /
    queue_depth / active_slots / healthy / warmup / start / stop /
    release_session / register_prefix / metrics). Followers: construct
    and call run_follower(); it returns when the leader stops."""

    def __init__(self, engine, tick_idle_s: float = 0.002,
                 tick_timeout_s: float = 60.0):
        self.engine = engine
        distributed = dist.is_initialized()
        self._comm = world_comm() if distributed else None
        self.process_index = dist.get_rank() if distributed else 0
        self.process_count = dist.get_world_size() if distributed else 1
        self.is_leader = self.process_index == 0
        self.tick_idle_s = tick_idle_s
        self.tick_timeout_s = tick_timeout_s
        if getattr(getattr(engine, "cfg", None), "watchdog_s", None) is not None:
            # A watchdog trip on ONE rank would recover that rank alone and
            # part the step streams; the tick monitor owns hang detection.
            logger.warning(
                "EngineConfig.watchdog_s is set under lockstep replication; "
                "per-rank watchdog trips can diverge ranks — prefer "
                "tick_timeout_s and leave watchdog_s=None"
            )
        self._last_tick = None
        self._wedged = False
        self._monitor: Optional[threading.Thread] = None
        self._logical_time = 0.0
        engine.clock = lambda: self._logical_time
        # Events serialized once at enqueue; a tick joins them.
        self._pending: "collections.deque[bytes]" = collections.deque()
        self._pending_submits = 0
        self._tagged: dict[int, "_LeaderHandle"] = {}
        self._handles: dict[str, RequestHandle] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.metrics = engine.metrics

    def _error_event(self, rid: str, error: str) -> StreamEvent:
        reasons = self.engine._finish_reasons
        return StreamEvent(rid, finish_reason=reasons.ERROR, error=error)

    # -- leader public surface (engine duck type) -----------------------

    def submit(self, prompt_tokens, params: SamplingParams = SamplingParams(),
               session_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> RequestHandle:
        if not self.is_leader:
            raise RuntimeError("submit() is leader-only; followers replicate")
        handle = _LeaderHandle(self)
        if self._wedged:
            # A wedged loop would never broadcast this submit.
            handle._push(self._error_event(
                "req-wedged", "lockstep tick stalled (peer process lost); engine unhealthy"))
            return handle
        event = {
            "op": "submit",
            "prompt": list(prompt_tokens),
            "params": {
                "temperature": params.temperature,
                "top_p": params.top_p,
                "top_k": params.top_k,
                "max_tokens": params.max_tokens,
                "stop_token_ids": list(params.stop_token_ids),
                "seed": params.seed,
            },
            "session_id": session_id,
            # The TTL rides the event and the engine anchors it to the
            # broadcast logical clock: sheds and deadline reaps happen at
            # the same step on every rank.
            "deadline_s": deadline_s,
            "tag": id(handle),
        }
        raw = json.dumps(event).encode()
        if len(raw) > _MAX_PAYLOAD - 256:
            handle._push(self._error_event(
                "req-oversize", f"prompt too large to replicate (> {_MAX_PAYLOAD} B tick)"))
            return handle
        with self._lock:
            self._pending.append(raw)
            self._pending_submits += 1
            self._tagged[id(handle)] = handle
        return handle

    def release_session(self, session_id: str) -> None:
        with self._lock:
            self._pending.append(json.dumps({"op": "release", "session_id": session_id}).encode())

    def register_prefix(self, tokens) -> None:
        """A prefix registration is an event: the shared-prefix pool's
        decisions must replay identically on every rank."""
        with self._lock:
            self._pending.append(json.dumps({"op": "register", "tokens": list(tokens)}).encode())

    def _enqueue_cancel(self, rid: str) -> None:
        with self._lock:
            self._pending.append(json.dumps({"op": "cancel", "rid": rid}).encode())

    def queue_depth(self) -> int:
        with self._lock:
            pending = self._pending_submits
        return self.engine.queue_depth() + pending

    def active_slots(self) -> int:
        return self.engine.active_slots()

    def decode_slots_active(self) -> int:
        return self.engine.decode_slots_active()

    def healthy(self) -> bool:
        return self.engine.healthy() and not self._wedged

    def supports_grammar(self) -> bool:
        """Grammars do not ride the tick events: none are attached."""
        return False

    def warmup(self, sessions: bool = True) -> None:
        # Collective: every rank warms up before its loop starts, running
        # the same task list (the engine checks that it is the same).
        self.engine.warmup()

    def generate(self, prompt_tokens, params: SamplingParams = SamplingParams()):
        """Synchronous helper: the lockstep loop drives the steps."""
        return self.submit(prompt_tokens, params).collect_tokens(timeout=600)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="omnia-lockstep", daemon=True)
        self._thread.start()
        self._start_monitor()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._join_monitor()

    def _join_monitor(self) -> None:
        # The monitor holds this object, and so the engine's device state,
        # until it ends.
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None

    def run_follower(self) -> None:
        """Followers block here, replicating the leader's step stream until
        the leader broadcasts its stop."""
        if self.is_leader:
            raise RuntimeError("run_follower() is for ranks other than 0")
        self._start_monitor()
        try:
            self._loop()
        finally:
            self._stop.set()
            self._join_monitor()

    # -- tick watchdog --------------------------------------------------

    def _start_monitor(self) -> None:
        if self._monitor is not None and self._monitor.is_alive():
            return
        # Baseline at start: a peer lost before the first tick completes
        # is still detected within the bound.
        self._last_tick = time.monotonic()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="omnia-lockstep-watchdog", daemon=True)
        self._monitor.start()

    def _monitor_loop(self) -> None:
        poll = min(1.0, self.tick_timeout_s / 4)
        while not self._stop.wait(poll):
            stalled = time.monotonic() - self._last_tick > self.tick_timeout_s
            if stalled and not self._wedged:
                self._declare_wedged()
            elif self._wedged and not stalled:
                # A step outlived the bound but the peers were alive: ticks
                # resumed, so readiness returns (failed handles stay failed).
                self._wedged = False
                logger.warning("lockstep ticks resumed on rank %d after a stall — "
                               "clearing wedged state", self.process_index)

    def _declare_wedged(self) -> None:
        """Bound a lost peer's blast radius: flip readiness and fail every
        live handle. The loop thread may stay stuck in the collective
        (a daemon: it ends with the process, whose restart is the
        recovery)."""
        self._wedged = True
        logger.error("lockstep tick stalled > %.0fs on rank %d/%d — peer process presumed "
                     "lost; marking engine unhealthy and failing live handles",
                     self.tick_timeout_s, self.process_index, self.process_count)
        err = "lockstep tick stalled (peer process lost); turn aborted, engine unhealthy"
        with self._lock:
            handles = list(self._tagged.values()) + list(self._handles.values())
        for h in handles:
            h._push(self._error_event(getattr(h, "request_id", "req-wedged"), err))

    # -- the lockstep loop ----------------------------------------------

    def _broadcast_tick(self, payload: bytes, stop: bool, t: float) -> tuple:
        """Header (length, stop, clock) every tick; the payload only when
        events exist. Returns (payload, stop, t) as every rank sees them."""
        if self._comm is None:
            return payload, stop, t
        hdr = np.zeros(_HDR_BYTES, np.uint8)
        if self.is_leader:
            hdr[:4] = np.frombuffer(len(payload).to_bytes(4, "big"), np.uint8)
            hdr[4] = 1 if stop else 0
            hdr[5:13] = np.frombuffer(np.float64(t).tobytes(), np.uint8)
        out = self._comm.broadcast(self._on_comm(hdr)).cpu().numpy()
        n = int.from_bytes(out[:4].tobytes(), "big")
        stop_f = bool(out[4])
        t_f = float(np.frombuffer(out[5:13].tobytes(), np.float64)[0])
        if n == 0:
            return b"", stop_f, t_f
        buf = np.zeros(n, np.uint8)
        if self.is_leader:
            buf[:] = np.frombuffer(payload, np.uint8)
        data = self._comm.broadcast(self._on_comm(buf)).cpu().numpy()
        return data.tobytes(), stop_f, t_f

    def _on_comm(self, a: np.ndarray) -> torch.Tensor:
        """A host buffer where the backend takes it: the rank's card for
        nccl, host memory for gloo."""
        t = torch.from_numpy(a)
        if self._comm.backend == "nccl":
            t = t.to(self.engine.device)
        return t

    def _drain_pending(self) -> list[bytes]:
        """Events up to the per-tick size budget, in order; the rest wait."""
        take: list[bytes] = []
        size = 2
        with self._lock:
            while self._pending:
                ev_len = len(self._pending[0]) + 1
                if take and size + ev_len > _DRAIN_BUDGET:
                    break
                size += ev_len
                raw = self._pending.popleft()
                if raw.startswith(b'{"op": "submit"'):
                    self._pending_submits -= 1
                take.append(raw)
        return take

    def _loop(self) -> None:
        idle_ticks = 0
        while True:
            if self.is_leader:
                raws = self._drain_pending()
                payload = (b"[" + b",".join(raws) + b"]") if raws else b""
                stop, t = self._stop.is_set(), time.monotonic()
            else:
                payload, stop, t = b"", False, 0.0
            try:
                payload, stop, t = self._broadcast_tick(payload, stop, t)
            except Exception:  # noqa: BLE001 - a lost peer: bounded response below
                # A lost peer surfaces as a hang (the monitor's job) or as a
                # collective error (gloo's closed connection): same meaning.
                logger.exception("lockstep tick broadcast failed")
                self._declare_wedged()
                return
            self._last_tick = time.monotonic()
            self._logical_time = t
            events = json.loads(payload.decode()) if payload else []
            for ev in events:
                self._apply(ev)
            if stop:
                return
            try:
                did = self.engine.step()
            except Exception:  # noqa: BLE001 - the loop must survive a step's failure
                # step() re-raises placement failures (the request's ERROR
                # is already pushed); recovery is deterministic, so every
                # rank recovers alike and the streams stay aligned.
                logger.exception("lockstep step failed; recovering")
                self.engine._recover("lockstep step failed")
                did = True
            if not did and not events:
                # A shared backoff every rank computes from the same
                # history, so ticks stay aligned while the engine idles.
                idle_ticks = min(idle_ticks + 1, 5)
                time.sleep(self.tick_idle_s * (2 ** idle_ticks))
            else:
                idle_ticks = 0

    def _apply(self, ev: dict) -> None:
        op = ev["op"]
        if op == "submit":
            p = ev["params"]
            sp = SamplingParams(
                temperature=p["temperature"], top_p=p["top_p"], top_k=p["top_k"],
                max_tokens=p["max_tokens"], stop_token_ids=tuple(p["stop_token_ids"]),
                seed=p["seed"],
            )
            real = self.engine.submit(ev["prompt"], sp, session_id=ev["session_id"],
                                      deadline_s=ev.get("deadline_s"))
            self._handles[real.request_id] = real
            if self.is_leader:
                with self._lock:
                    wrapper = self._tagged.pop(ev["tag"], None)
                if wrapper is not None:
                    wrapper._bind(real)
        elif op == "cancel":
            real = self._handles.get(ev["rid"])
            if real is not None:
                real.cancel()
        elif op == "release":
            self.engine.release_session(ev["session_id"])
        elif op == "register":
            self.engine.register_prefix(ev["tokens"])
        # Bound the map without evicting live requests: a trimmed live
        # handle would turn its later cancel into a silent no-op.
        if len(self._handles) > 4096:
            live = self.engine.live_request_ids()
            keep_live = {r: h for r, h in self._handles.items() if r in live}
            rest = [(r, h) for r, h in self._handles.items() if r not in live]
            self._handles = dict(rest[-1024:]) | keep_live


class _LeaderHandle(RequestHandle):
    """The handle submit() returns before its event is broadcast: events
    forward from the engine's real handle once the tick binds it; cancel
    is an event, so every rank applies it at the same step."""

    def __init__(self, owner: LockstepEngine):
        super().__init__("pending")
        self._owner = owner
        self._real: Optional[RequestHandle] = None
        self._bound = threading.Event()

    def _bind(self, real: RequestHandle) -> None:
        self.request_id = real.request_id
        self._real = real

        def pump():
            for ev in real.events(timeout=None):
                self._push(ev)
                if ev.is_final:
                    return

        threading.Thread(target=pump, daemon=True).start()
        self._bound.set()

    def cancel(self) -> None:
        super().cancel()
        if self._real is not None:
            self._owner._enqueue_cancel(self._real.request_id)
        else:
            # Not broadcast yet: the cancel must reach every rank after the
            # submit does.
            def late():
                if self._bound.wait(timeout=30) and self._real is not None:
                    self._owner._enqueue_cancel(self._real.request_id)

            threading.Thread(target=late, daemon=True).start()

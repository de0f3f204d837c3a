"""Engine thread lifecycle (port of ``omnia_tpu/engine/lifecycle.py``):
the step loop, graceful drain (which pages idle sessions to host), and
the recovery that turns a failed (or watchdog-tripped) step into failed
handles plus fresh device state instead of a dead engine.

On the card a recovery counts as done only once the stream has run it:
after a watchdog trip, health returns when an event recorded after the
new caches completes within ``watchdog_s``. An injected (host-side) hang
recovers so. On a stream wedged for real the reallocation's pageable
copies wait for the stream, so the recovery waits with health false,
for good if it never drains, and the operator replaces the pod
(ROADMAP §C)."""

from __future__ import annotations

import logging
import threading
import time

import torch

from omnia_tpu_torch.engine.types import FinishReason

logger = logging.getLogger(__name__)


class _LifecycleMixin:
    """Thread-loop / drain / recovery methods of :class:`InferenceEngine`."""

    def start(self):
        if self._thread is not None:
            return
        with self._lock:
            self._draining = False
        if self._timeline is not None:
            self._timeline.anchor()
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop, name="omnia-torch-engine", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = False, drain_timeout_s: float = 30.0):
        """Stop the loop. drain=True first stops admission (submit sheds
        OVERLOADED) and lets queued and active requests finish, bounded
        by drain_timeout_s; leftovers then get their terminal event, and
        idle sessions' rows are offloaded to host RAM."""
        if drain:
            with self._lock:
                self._draining = True
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline and self._drain_work_left():
                if self._thread is None:
                    if not self.step():
                        time.sleep(0.001)
                else:
                    time.sleep(0.002)
        wedged = False
        if self._thread is not None:
            self._stop_event.set()
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                logger.error("engine loop did not stop within 30s; still alive")
                self._healthy = False
                wedged = True
            else:
                self._thread = None
        if drain:
            with self._lock:
                leftover, self._waiting = self._waiting, []
            for req, handle in leftover:
                self._push_final(handle, req.request_id, FinishReason.OVERLOADED,
                                 error="engine draining: drain window elapsed while queued",
                                 num_prompt_tokens=len(req.prompt_tokens))
                self.metrics["requests_finished"] += 1
                if self._flight is not None:
                    self._flight.note_terminal(req.request_id, FinishReason.OVERLOADED.value,
                                               error="drain window elapsed while queued")
            if not wedged and any(s.active for s in self._slots):
                self._fail_all("engine stopped: drain window elapsed mid-request")
        if drain and not wedged and self._healthy:
            # The loop has joined, so device state is this caller's.
            self._offload_idle_sessions()
        if self._devloop is not None:
            # A poisoned drainer's thread is stuck in the hung read that
            # tripped the watchdog: stop() does not wait for it. A later
            # start() builds a fresh one at its first read.
            self._devloop.stop()

    def _drain_work_left(self) -> bool:
        # An interleaved prefill holds its _placing claim until its last
        # piece, so it counts as work left.
        with self._lock:
            if self._waiting or self._placing > 0:
                return True
        return self.active_slots() > 0

    def _loop(self):
        while not self._stop_event.is_set():
            try:
                if not self.step():
                    time.sleep(0.001)
            except Exception:
                logger.exception("engine step failed")
                self._recover("engine step failed")
                time.sleep(0.1)

    def _recover(self, msg: str):
        """Fail in-flight requests and reallocate device state: a step
        that raised mid-chunk leaves the caches and slot state half
        written."""
        self._fail_all(msg)
        # The chunks' pinned host buffers may still have copies queued:
        # the caching host allocator records an event for each
        # non-blocking copy and reuses no block before it completes.
        self._inflight.clear()
        if self._timeline is not None:
            self._timeline.reset()
        # Device-resident session rows die with the caches; host-paged
        # sessions keep theirs.
        for sess in self._sessions.values():
            if sess.slot is not None:
                self._slots[sess.slot].session_id = None
                sess.slot = None
                sess.token_ids = []
        try:
            # On the card with the ring on the captured chunks and prefills
            # die with the state and are captured again on the new one; a
            # poisoned drainer is replaced at the next read (devloop.py).
            self._init_device_state()
            self._ring()
            self._prefill_graphs()
            self.metrics["recoveries"] += 1
            self._healthy = self._stream_ran_recovery()
        except Exception:
            logger.exception("engine recovery failed; marking unhealthy")
            self._healthy = False

    def _stream_ran_recovery(self) -> bool:
        """With the watchdog on the card: whether an event recorded after
        the reallocation completes within ``watchdog_s`` (its kernels are
        only enqueued when it returns). True otherwise."""
        if self.cfg.watchdog_s is None or self.device.type != "cuda":
            return True
        done = torch.cuda.Event()
        done.record()
        deadline = time.monotonic() + self.cfg.watchdog_s
        while not done.query():
            if time.monotonic() >= deadline:
                logger.error("the stream did not run the recovery within watchdog_s=%s; "
                             "staying unhealthy", self.cfg.watchdog_s)
                return False
            time.sleep(0.001)
        return True

    def _fail_all(self, msg: str):
        # A half-prefilled placement (engine/interleave.py) is neither
        # queued nor active: fail it here or its handle would hang.
        self._fail_prefilling(msg)
        for slot in self._slots:
            if slot.active:
                self._push_final(slot.handle, slot.request.request_id, FinishReason.ERROR,
                                 error=msg, num_prompt_tokens=len(slot.request.prompt_tokens),
                                 num_generated_tokens=slot.generated)
                self.metrics["requests_finished"] += 1
                if self._flight is not None:
                    self._flight.note_terminal(
                        slot.request.request_id, FinishReason.ERROR.value,
                        tokens=slot.generated, error=msg,
                        first_token_at=slot.handle.first_token_at)
                self._release_slot_seed(slot)
                slot.clear()

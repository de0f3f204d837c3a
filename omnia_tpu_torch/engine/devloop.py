"""Device-resident decode loop: the host half of the token ring (port of
``omnia_tpu/engine/devloop.py``).

The device half lives in ``programs.py`` (the ring edition of the decode
step: the deadline-step budget, per-slot grammar EOS, the all-done
early-out) and, on the card, ``graphs.py`` (the captured chunk). This
module owns what the ring needs on the host:

- ``validate_decode_ring``: 0 is off, 1 is refused, >= 2 is a ring.
- ``ChunkDrainer``: ONE long-lived daemon thread per engine that runs a
  decode chunk's device-to-host token read (the chunk's own ``read``:
  ``event.synchronize()`` on its CUDA event, then the pinned host
  buffer's ``numpy()``). The ring hands it a chunk's read at dispatch
  (async drain); the watchdog waits for it with a timeout.
- ``RingGate``: the online A/B self-gate that probes realized tokens/s
  with async drain permitted and suppressed, and holds the drain off
  per engine when it does not pay.
- ``DevLoopState``: the per-engine container (ring depth, capacity,
  gate, the step-time EMA, the drainer). ``decode_ring=0`` with no
  watchdog builds none of it.

Threading contract: the drainer thread only ever touches the queue, the
entries and its own stats; the engine thread owns the pipeline deque.
The lock guards the counters only: every blocking call (the queue get,
the injected sleep, the read) happens outside it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional


def validate_decode_ring(cfg) -> None:
    """Refuse an unservable ring at construction: 0 is off, >= 2 a ring;
    1 cannot overlap a drain with the next dispatch, so it is a
    misconfiguration, not a degraded mode."""
    ring = getattr(cfg, "decode_ring", 0)
    if ring < 0:
        raise ValueError(f"decode_ring must be >= 0, got {ring}")
    if ring == 1:
        raise ValueError(
            "decode_ring=1 is a one-deep ring (drain can never overlap "
            "dispatch) — use 0 (off) or >= 2"
        )


class DrainEntry:
    """One read handed to the drainer. ``result`` holds the host ndarray
    on success or the raised exception (the engine thread re-raises it:
    a failed read takes the same recovery path as a failed inline one);
    ``done`` flips either way."""

    __slots__ = ("read", "pre_sleep_s", "on_drained", "result", "done")

    def __init__(self, read: Callable[[], Any], pre_sleep_s: float = 0.0,
                 on_drained: Optional[Callable[[Any, float], None]] = None):
        self.read = read
        self.pre_sleep_s = pre_sleep_s  # the fault-injection seam
        self.on_drained = on_drained
        self.result: Any = None
        self.done = threading.Event()


_STOP = object()


class ChunkDrainer:
    """ONE long-lived ``omnia-chunk-drainer`` daemon thread per engine.

    The engine thread ``submit()``s a chunk's read; the drainer runs the
    reads FIFO and flips each entry's ``done`` event. ``wait()`` is the
    watchdog seam: a timeout poisons this drainer (its thread is stuck
    in a hung read and can never be reclaimed), and the owner builds a
    fresh one after recovery."""

    def __init__(self, name: str = "omnia-chunk-drainer"):
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self.drains = 0         # guarded-by: _lock
        self.drain_s = 0.0      # guarded-by: _lock
        self.poisoned = False   # guarded-by: _lock
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            entry = self._queue.get()
            if entry is _STOP:
                return
            t0 = time.monotonic()
            try:
                if entry.pre_sleep_s > 0.0:
                    time.sleep(entry.pre_sleep_s)
                arr = entry.result = entry.read()
            except Exception as exc:  # noqa: BLE001 - parked for the engine thread
                entry.result = exc
                arr = None
            took = time.monotonic() - t0
            entry.done.set()
            with self._lock:
                self.drains += 1
                self.drain_s += took
            if entry.on_drained is not None:
                try:
                    entry.on_drained(arr, took)
                except Exception:  # noqa: BLE001 - observability must not kill the drainer
                    pass

    def submit(self, read: Callable[[], Any], pre_sleep_s: float = 0.0,
               on_drained: Optional[Callable[[Any, float], None]] = None) -> DrainEntry:
        """Enqueue a read; returns at once with its entry. ``on_drained(host
        array or None, seconds)`` runs on the drainer thread after it."""
        entry = DrainEntry(read, pre_sleep_s, on_drained)
        self._queue.put(entry)
        return entry

    def wait(self, entry: DrainEntry, timeout: Optional[float] = None) -> Optional[Any]:
        """Block until the entry drains. Returns the host array, raises
        the parked exception, or returns None on timeout, after which
        this drainer is poisoned and must be replaced."""
        if not entry.done.wait(timeout):
            with self._lock:
                self.poisoned = True
            return None
        if isinstance(entry.result, BaseException):
            raise entry.result
        return entry.result

    def stats(self) -> tuple[int, float]:
        with self._lock:
            return self.drains, self.drain_s

    def stop(self, timeout: float = 5.0) -> None:
        """Shut the thread down. A poisoned drainer's thread is stuck in
        a hung read: it is not waited for."""
        with self._lock:
            poisoned = self.poisoned
        self._queue.put(_STOP)
        if not poisoned:
            self._thread.join(timeout)


class RingGate:
    """Online self-gate for the token ring: a duty-cycle probe of realized
    decode throughput with async drain permitted vs suppressed.

    The spec-decode ``_SpecGate`` state machine verbatim:
    PROBE_ASYNC(window ticks) → PROBE_SYNC(window) → decide →
    HOLD_ON/HOLD_OFF(window × hold_factor) → re-probe. A tick is one
    processed decode chunk; a phase's rate is tokens over wall seconds
    across it. Both arms replay the same ring programs (greedy streams
    stay identical); only where the read blocks differs. Async must be
    at least ``margin`` of the sync rate to stay on. The engine skips
    ticking under an injected clock, where a wall-clock decision could
    diverge lockstep replicas."""

    PROBE_ASYNC, PROBE_SYNC, HOLD_ON, HOLD_OFF = range(4)
    _NAMES = {PROBE_ASYNC: "probe_async", PROBE_SYNC: "probe_sync",
              HOLD_ON: "on", HOLD_OFF: "off"}

    def __init__(self, window: int, hold_factor: int = 8, margin: float = 0.98):
        self.window = window
        self.hold_factor = hold_factor
        self.margin = margin
        self.state = self.PROBE_ASYNC
        self.ticks = 0
        self.phase_t0: Optional[float] = None
        self.phase_tok0 = 0
        self.rate_async: Optional[float] = None
        self.rate_sync: Optional[float] = None
        self.decisions = 0
        self.disables = 0

    def allows_async(self) -> bool:
        return self.state in (self.PROBE_ASYNC, self.HOLD_ON)

    def state_code(self) -> int:
        """The metric's encoding: 0 = probing, 1 = on, 2 = off."""
        if self.state == self.HOLD_ON:
            return 1
        if self.state == self.HOLD_OFF:
            return 2
        return 0

    def tick(self, now: float, tokens: int) -> bool:
        """Advance one processed chunk; returns whether async drain is
        permitted for the next dispatch."""
        if self.window <= 0:
            return True
        if self.phase_t0 is None:
            self.phase_t0, self.phase_tok0 = now, tokens
        self.ticks += 1
        probing = self.state in (self.PROBE_ASYNC, self.PROBE_SYNC)
        limit = self.window if probing else self.window * self.hold_factor
        if self.ticks >= limit:
            rate = (tokens - self.phase_tok0) / max(now - self.phase_t0, 1e-9)
            if self.state == self.PROBE_ASYNC:
                self.rate_async = rate
                self.state = self.PROBE_SYNC
            elif self.state == self.PROBE_SYNC:
                self.rate_sync = rate
                self.decisions += 1
                if (self.rate_async or 0.0) >= rate * self.margin:
                    self.state = self.HOLD_ON
                else:
                    self.state = self.HOLD_OFF
                    self.disables += 1
            else:
                # Hold expired: refresh that mode's rate and re-probe.
                if self.state == self.HOLD_ON:
                    self.rate_async = rate
                else:
                    self.rate_sync = rate
                self.state = self.PROBE_ASYNC
            self.ticks = 0
            self.phase_t0, self.phase_tok0 = now, tokens
        return self.allows_async()

    def report(self) -> dict:
        r = lambda v: None if v is None else round(v, 2)  # noqa: E731
        return {
            "state": self._NAMES[self.state],
            "rate_async_tok_s": r(self.rate_async),
            "rate_sync_tok_s": r(self.rate_sync),
            "decisions": self.decisions,
            "disables": self.disables,
        }


# RingGate probe phase length, in processed chunks (fixed, as in the JAX
# package: a chunk already aggregates decode_chunk steps).
_GATE_WINDOW = 32

# Per-step seconds for the deadline-to-steps conversion before the first
# chunk lands (the EMA's warm start).
_STEP_EMA_INIT = 5e-3


class DevLoopState:
    """Per-engine device-resident-loop state. Exists when the ring is on
    OR a watchdog is set (the drainer serves both); ``decode_ring=0``
    with no watchdog builds nothing at all."""

    def __init__(self, ring: int = 0, gate: bool = True):
        self.ring = ring
        # Undrained-chunk capacity: the pipeline may hold this many
        # dispatched-but-unprocessed chunks before a dispatch processes
        # the oldest (ring_full_stalls). A watchdog-only engine (ring 0)
        # keeps the pipeline policy it had.
        self.capacity = max(2, ring) if ring > 0 else 0
        self.gate: Optional[RingGate] = RingGate(_GATE_WINDOW) if ring > 0 and gate else None
        # Host EMA of one decode step's wall time, for the deadline-step
        # budget. Engine-thread-owned.
        self.step_ema_s = _STEP_EMA_INIT
        self._drainer: Optional[ChunkDrainer] = None

    def get_drainer(self) -> ChunkDrainer:
        """The live drainer, replacing a poisoned one (a watchdog trip
        leaves the old thread in the hung read: recovery needs a fresh
        lane)."""
        d = self._drainer
        if d is None or d.poisoned:
            if d is not None:
                d.stop()
            d = self._drainer = ChunkDrainer()
        return d

    def drainer_if_live(self) -> Optional[ChunkDrainer]:
        d = self._drainer
        if d is None or d.poisoned:
            return None
        return d

    def observe_step_time(self, per_step_s: float) -> None:
        """Fold one chunk's realized per-step wall time into the EMA."""
        self.step_ema_s += 0.2 * (per_step_s - self.step_ema_s)

    def async_engaged(self, wall_clock: bool) -> bool:
        """Whether the next dispatch hands its read to the drainer. The
        gate binds only under the wall clock: an engine on an injected
        clock keeps async drain unconditionally."""
        if self.ring <= 0:
            return False
        if self.gate is None or not wall_clock:
            return True
        return self.gate.allows_async()

    def stop(self) -> None:
        if self._drainer is not None:
            self._drainer.stop()
            self._drainer = None

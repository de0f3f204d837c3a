"""The chunk drainer behind the hung-dispatch watchdog (port of the
drainer half of ``omnia_tpu/engine/devloop.py``).

- ``ChunkDrainer``: ONE long-lived daemon thread per engine that runs a
  decode chunk's device-to-host token read (the chunk's own ``read``:
  ``event.synchronize()`` on its CUDA event, then the pinned host
  buffer's ``numpy()``), so that the engine thread can wait for it with
  a timeout.
- ``DevLoopState``: the per-engine container of the drainer's
  lifecycle. The engine builds one only when ``watchdog_s`` is set;
  without it no thread exists.

The decode ring (``RingGate``, ``validate_decode_ring``, the ring's
capacity and the step-time EMA) is not ported: it needs the captured
decode chunk (ROADMAP A item 2).

Threading contract: the drainer thread only ever touches the queue, the
entries and its own ``poisoned`` flag; the engine thread owns the
pipeline deque. The lock guards the flag only: every blocking call (the
queue get, the injected sleep, the read) happens outside it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional


class DrainEntry:
    """One read handed to the drainer. ``result`` holds the host ndarray
    on success or the raised exception (the engine thread re-raises it:
    a failed read takes the same recovery path as a failed inline one);
    ``done`` flips either way."""

    __slots__ = ("read", "pre_sleep_s", "result", "done")

    def __init__(self, read: Callable[[], Any], pre_sleep_s: float = 0.0):
        self.read = read
        self.pre_sleep_s = pre_sleep_s  # the fault-injection seam
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
        self.poisoned = False   # guarded-by: _lock
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            entry = self._queue.get()
            if entry is _STOP:
                return
            try:
                if entry.pre_sleep_s > 0.0:
                    time.sleep(entry.pre_sleep_s)
                entry.result = entry.read()
            except Exception as exc:  # noqa: BLE001 - parked for the engine thread
                entry.result = exc
            entry.done.set()

    def submit(self, read: Callable[[], Any], pre_sleep_s: float = 0.0) -> DrainEntry:
        """Enqueue a read; returns at once with its entry."""
        entry = DrainEntry(read, pre_sleep_s)
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

    def stop(self, timeout: float = 5.0) -> None:
        """Shut the thread down. A poisoned drainer's thread is stuck in
        a hung read: it is not waited for."""
        with self._lock:
            poisoned = self.poisoned
        self._queue.put(_STOP)
        if not poisoned:
            self._thread.join(timeout)


class DevLoopState:
    """Per-engine drainer lifecycle; exists only when a watchdog is set."""

    def __init__(self):
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

    def stop(self) -> None:
        if self._drainer is not None:
            self._drainer.stop()
            self._drainer = None

"""Offers a mix's load to an engine and stamps what comes back.

The engine runs on its own thread; this module's loop, on the caller's
thread, submits each request when it is due (open loop) or when its
client's previous one has ended (closed loop). Every event a request's
handle receives is stamped with the host's monotonic clock at the
moment the engine pushes it: the handle's queue is replaced by a
recorder, so no reader thread polls and nothing waits to be read.

The window: the load starts, runs ``lead_in_s`` so that the slots reach
their steady state, then the measured window of ``seconds``. After the
window the load goes on until every request due in the window has its
first token (at most ``settle_s``), so that a request still queued at
the close keeps its place in the time-to-first-token tail.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from portbench.traffic import Traffic


@dataclass
class Record:
    """One request as the client saw it; times on ``time.monotonic``."""

    index: int
    prompt_len: int
    max_tokens: int
    greedy: bool
    due: float
    submitted: float = 0.0
    request_id: str = ""
    token_times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    ended: Optional[float] = None
    reason: Optional[str] = None
    error: Optional[str] = None

    @property
    def first(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    @property
    def ok(self) -> bool:
        return self.reason in ("length", "stop")


class _Stamped:
    """Stands in for a handle's event queue: records each event with the
    time it was pushed and tells the load loop when the request ends."""

    def __init__(self, rec: Record, handle, on_end: Callable[[Record], None]):
        self.rec, self.handle, self.on_end = rec, handle, on_end

    def put(self, event) -> None:
        now = time.monotonic()
        if event.token_id is not None:
            self.rec.token_times.append(now)
            self.rec.tokens.append(int(event.token_id))
        if event.is_final:
            self.rec.request_id = self.handle.request_id
            self.rec.ended = now
            self.rec.reason = getattr(event.finish_reason, "value", str(event.finish_reason))
            self.rec.error = event.error
            self.on_end(self.rec)


class Load:
    """Runs one mix against ``engine`` (an InferenceEngine or a
    LockstepEngine leader): ``run()`` returns the records and the window."""

    def __init__(self, engine, traffic: Traffic, mix: dict, seconds: float,
                 sampling_params: Callable, marks: tuple = (),
                 on_mark: Callable[[str, float], None] = None):
        self.engine, self.traffic, self.mix = engine, traffic, mix
        self.seconds = seconds
        self.sampling_params = sampling_params
        # (seconds after the window opens, name): on_mark(name, now) is
        # called from the load loop when each is reached; "open" at 0 and
        # "close" at the window's end always.
        self.marks = sorted([(0.0, "open"), (seconds, "close"), *marks])
        self.on_mark = on_mark or (lambda name, t: None)
        self.records: list[Record] = []
        self._ended: collections.deque = collections.deque()
        self._wake = threading.Event()
        self.late_s: list[float] = []           # how late each submit ran
        self.queue_depths: list[int] = []       # the engine's queue, every half second

    def _end(self, rec: Record) -> None:
        self._ended.append(rec)
        self._wake.set()

    def _submit(self, i: int, due: float) -> Record:
        req = self.traffic.request(i)
        rec = Record(i, len(req.prompt), req.max_tokens, req.greedy, due)
        rec.submitted = time.monotonic()
        self.late_s.append(rec.submitted - due)
        handle = self.engine.submit(req.prompt.tolist(), self.sampling_params(req))
        early = handle._queue
        handle._queue = _Stamped(rec, handle, self._end)
        while not early.empty():            # pushed before the swap (a refusal)
            handle._queue.put(early.get_nowait())
        self.records.append(rec)
        return rec

    def run(self) -> tuple[list[Record], float, float]:
        mix = self.mix
        start = time.monotonic()
        t0 = start + mix["lead_in_s"]
        t1 = t0 + self.seconds
        settle_until = t1 + mix.get("settle_s", 60.0)
        marks = [(t0 + off, name) for off, name in self.marks]
        closed = False
        nxt = 0
        sampled = 0.0
        if not self.traffic.open_loop:
            for _ in range(mix["clients"]):
                self._submit(nxt, time.monotonic())
                nxt += 1
        while True:
            now = time.monotonic()
            while marks and now >= marks[0][0]:
                name = marks.pop(0)[1]
                closed = closed or name == "close"
                self.on_mark(name, now)
            if closed and (now >= settle_until or self._settled(t0, t1)):
                break
            if t0 <= now < t1 and now - sampled >= 0.5:
                sampled = now
                self.queue_depths.append(self.engine.queue_depth())
            wait = 0.05
            if self.traffic.open_loop:
                while start + self.traffic.due(nxt) <= now:
                    self._submit(nxt, start + self.traffic.due(nxt))
                    nxt += 1
                wait = start + self.traffic.due(nxt) - time.monotonic()
            else:
                while self._ended:
                    self._ended.popleft()
                    self._submit(nxt, time.monotonic())
                    nxt += 1
            if marks:
                wait = min(wait, marks[0][0] - now)
            if wait > 0:
                self._wake.wait(min(wait, 0.05))
                self._wake.clear()
        return self.records, t0, t1

    def _settled(self, t0: float, t1: float) -> bool:
        """Every request due in the window has its first token or has ended."""
        return all(r.token_times or r.ended is not None
                   for r in self.records if t0 <= r.due < t1)

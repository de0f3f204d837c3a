"""What the traced run (``--trace 1``) records around the program.

- ``Spans``: wrappers the benchmark sets on one engine instance around
  the calls into its layers: each decode chunk's enqueue
  (``_run_decode_step``), each prefill or extend program, each chunk's
  read (``_process_oldest_chunk``) and each scheduling step (``step``).
  Each call keeps its host interval (monotonic and wall-clock ns) and,
  on the card, a CUDA event pair, so that a decode chunk's or a
  prefill's device time is read without the profiler. They are the
  pattern of ``chip_smoke.py::busy_window``, kept here until the engine
  times these itself.
- ``Profile``: ``torch.profiler`` over a span of the window: every
  device operation's name and interval (graph replays list their
  kernels one by one), reduced to the busy time (the union of the
  intervals), the time by operation, and the idle gaps labelled by
  which of the spans above the engine thread was in when the device
  went idle.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

_PREFILL = ("_prefill_insert_fn", "_extend_fn", "_extend_nosample_fn")
_HOST = {"step": "host: engine step (scheduling)",
         "_process_oldest_chunk": "host: reading a decode chunk",
         "_run_decode_step": "host: enqueueing a decode chunk",
         "prefill": "host: a prefill or extend program"}


@dataclass
class Span:
    kind: str
    t0: float
    t1: float = 0.0
    ns0: int = 0
    ns1: int = 0
    events: Optional[tuple] = None

    def device_ms(self) -> float:
        e0, e1 = self.events
        return e0.elapsed_time(e1)


class Spans:
    """Host spans and CUDA event pairs around one engine's layer calls."""

    def __init__(self, engine):
        self.engine = engine
        self.cuda = engine.device.type == "cuda"
        self.spans: list[Span] = []
        self._names: list[str] = []
        self._hold = threading.Event()
        self._parked = threading.Event()
        self._resume = threading.Event()

    def _wrap(self, attr: str, kind: str, timed: bool) -> None:
        inner = getattr(self.engine, attr)
        spans, cuda = self.spans, self.cuda

        def wrapped(*args, **kwargs):
            if kind == "step" and self._hold.is_set():
                self._parked.set()
                self._resume.wait()
            s = Span(kind, time.monotonic(), ns0=time.time_ns())
            if timed and cuda:
                s.events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                s.events[0].record()
            try:
                return inner(*args, **kwargs)
            finally:
                if s.events is not None:
                    s.events[1].record()
                s.t1, s.ns1 = time.monotonic(), time.time_ns()
                spans.append(s)

        setattr(self.engine, attr, wrapped)
        self._names.append(attr)

    def install(self) -> "Spans":
        self._wrap("step", "step", False)
        self._wrap("_process_oldest_chunk", "_process_oldest_chunk", False)
        self._wrap("_run_decode_step", "_run_decode_step", True)
        for attr in _PREFILL:
            if getattr(self.engine, attr, None) is not None:
                self._wrap(attr, "prefill", True)
        return self

    def hold(self, timeout_s: float = 5.0) -> None:
        """Park the engine thread between two steps (the profiler starts
        and stops with no launch of the engine's in flight on the host)."""
        self._resume.clear()
        self._parked.clear()
        self._hold.set()
        self._parked.wait(timeout_s)

    def release(self) -> None:
        self._hold.clear()
        self._resume.set()

    def remove(self) -> None:
        """Unwrap, and let go of the engine, so that it can be freed."""
        for attr in self._names:
            delattr(self.engine, attr)
        self._names = []
        self.engine = None

    def within(self, kind: str, t0: float, t1: float) -> list:
        return [s for s in self.spans if s.kind == kind and t0 <= s.t0 < t1]


@dataclass
class Profile:
    """The device's operations over the traced span."""

    ns0: int = 0
    ns1: int = 0
    ops: list = field(default_factory=list)       # (name, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.ns1 - self.ns0) / 1e9

    def busy_intervals(self) -> list:
        """The union of the operations' intervals, clipped to the span."""
        out: list = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.ns0), min(b, self.ns1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def op_seconds(self, pattern: str) -> float:
        return sum(b - a for n, a, b in self.ops if pattern in n) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0) + (b - a)
        return [[k[:120], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: list, n: int = 10, short_ns: int = 20_000) -> list:
        """Idle time on the device, summed by what the engine thread was
        doing when each gap began (the innermost span open then). Gaps
        shorter than ``short_ns`` are one entry of their own: the spaces
        between the operations of a step."""
        busy = self.busy_intervals()
        if not busy:
            return [["device: no operation in the span", self.window_s]]
        edges = [(self.ns0, busy[0][0])]
        edges += [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        edges.append((busy[-1][1], self.ns1))
        spans = sorted(spans, key=lambda s: s.ns0)
        starts = [s.ns0 for s in spans]
        by: dict = {}
        for a, b in edges:
            if b <= a:
                continue
            label = "device: gaps under 20 us between operations"
            if b - a >= short_ns:
                label, width = "host: engine thread outside a step", None
                i = bisect.bisect_right(starts, a)
                for s in spans[max(0, i - 64):i]:
                    if a < s.ns1 and (width is None or s.ns1 - s.ns0 < width):
                        label, width = _HOST.get(s.kind, s.kind), s.ns1 - s.ns0
            by[label] = by.get(label, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """torch.profiler on the card over [start(), stop()]; nothing elsewhere.

    The profiler's first session in a process sets up CUPTI, which takes
    seconds: ``prepare()`` pays that in the run's set-up with a session
    over one small operation, so that ``start()`` inside the window only
    begins recording. (A session left in the profiler's warmup state
    instead would collect every kernel until it starts, and discarding
    them stalls the caller for seconds.)"""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._prof = None
        self.result: Optional[Profile] = None

    def _session(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def prepare(self) -> None:
        if not self.cuda:
            return
        with self._session():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        if not self.cuda:
            return
        self._prof = self._session()
        self._prof.__enter__()
        self.result = Profile(ns0=time.time_ns())

    def stop(self) -> None:
        if self._prof is None:
            return
        self.result.ns1 = time.time_ns()
        self._prof.__exit__(None, None, None)

    def read(self) -> Optional[Profile]:
        """The device operations, read once the load has ended."""
        if self._prof is None or not self.result.ns1:
            return None
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                self.result.ops.append((e.name(), e.start_ns(), e.end_ns()))
        self._prof = None
        return self.result if self.result.ops else None

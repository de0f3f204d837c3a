"""The decode step's device timeline: region stamps inside the step, and
device intervals of the engine's decode chunks and placement programs
(the engine keeps one :class:`Timeline` with the flight recorder on,
``EngineConfig.flight_events > 0``; none, and nothing below made or
launched, with it off).

- **Region stamps.** ``stamp(label)`` is the seam that
  ``models/llama.py::_layer`` and ``forward``, ``ops/moe.py::_experts``
  and ``engine/programs.py::_step`` call at a region's start. It reads
  one thread-local recorder, which the engine sets only around a timed
  decode chunk (the eager chunk, or the capture of the ring's chunks),
  so a prefill, an extend, a mixed or verify step and training stamp
  nothing. On the card a stamp is a one-thread kernel
  (``csrc/stamps.cu``) that writes the GPU's nanosecond timer into
  ``[step, i]`` of the chunk's buffer; captured into the ring's graph
  it is a kernel node of the step's IF body, so a step the early-out
  skips leaves its row zero (the graph zeroes the buffer first). On the
  CPU the ops are synchronous and a stamp reads ``time.perf_counter_ns``.
  The regions, each the time from its label's stamp to the next stamp:
  ``attn`` (``ln1`` to the residual add after ``wo``: q/k/v, rope, the
  KV write, the attention kernel), ``ffn`` (``ln2`` to the MLP's
  residual add: the dense SwiGLU, or the whole MoE block), ``experts``
  (the MoE's expert products, inside ``ffn``; the rest of a MoE layer's
  ``ffn`` is ``moe_route``: router, top-k, assignment sort, gather,
  combine), ``head`` (the final norm, the head product, the logits'
  gather and the sampler, the grammar mask included). Before the first
  stamp (the embedding, rope's tables) and after the last (the state's
  bookkeeping, the IF predicates) is in no region.
- **Device intervals.** A timing event pair around each decode chunk
  (``_run_decode_step``, replay or eager) and each prefill, extend or
  insert program (the placement seams that note a ``prefill_piece``),
  resolved when a chunk is read, which already waits for the device,
  and at later placements (a pair whose end has completed). The stamp
  buffer is copied to pinned memory with the chunk's tokens and read
  under the same event, so reading it adds no synchronize.
- **Wall clock.** An interval is placed on the host's wall clock
  (``time.time_ns``, the Unix epoch) through an anchor event, recorded
  on an idle stream and bracketed by the host's clock (``anchor``): when
  the engine is built, when it starts serving and after warmup's
  restore, and again at a mark taken ``REANCHOR_NS`` or more after the
  last anchor while the stream is idle (so that nothing is waited for):
  the card's clock drifts from the host's by some parts per million. Each
  mark keeps the anchor it was taken under. That is the clock of
  ``torch.profiler``'s kernel records on the card (CUPTI's activity
  timestamps, which the profiler reports in Unix-epoch ns), so a chunk's
  interval holds its replay's kernels in a profiler trace of the same
  run (``tests/test_torch_timeline_cuda.py``). Event times are float
  milliseconds from the anchor, so on a card that never idles the anchor
  moves to a read chunk's end every ``REBASE_NS``, to keep them to the
  microsecond.

The counters (``TIMELINE_KEYS``, in ``engine.metrics``, added at each
chunk's read and 0 with the recorder off): the steps that ran, the ns
of each region summed over them, the chunks' event-pair ns, and the
device ns from one chunk's end event to the next chunk's start event
(``decode_gap_ns``), with the part in gaps that hold a placement
program (``decode_gap_placement_ns``). A stretch with no active slot is
no gap: the next chunk after it starts afresh.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

#: The engine's timeline counters (``engine.metrics``), always present.
TIMELINE_KEYS = frozenset({
    "decode_timed_steps", "decode_attn_ns", "decode_ffn_ns", "decode_moe_route_ns",
    "decode_head_ns", "decode_chunk_device_ns", "decode_gap_ns", "decode_gap_placement_ns",
})
#: A decode chunk's split, each region's ns summed over its steps.
REGIONS = ("attn", "ffn", "experts", "moe_route", "head")
#: The regions the counters sum (``decode_<region>_ns``).
COUNTED = ("attn", "ffn", "moe_route", "head")
#: How old (host ns) the anchor is before a mark on an idle stream takes a new one.
REANCHOR_NS = 1_000_000_000
#: Events an anchor records at most, and the host window it takes one within.
ANCHOR_TRIES = 8
ANCHOR_WINDOW_NS = 30_000
#: How far past the anchor (device ns) a read chunk's end becomes the anchor.
REBASE_NS = 10_000_000_000

_local = threading.local()


def stamp(label: str) -> None:
    """A region of the decode step starts here: ``attn``, ``ffn``,
    ``experts``, ``route`` (the MoE after its experts), ``head``, and
    ``end`` after the sampler. Nothing unless the engine set a recorder
    on this thread."""
    stamps = getattr(_local, "stamps", None)
    if stamps is not None:
        stamps.stamp(label)


@contextlib.contextmanager
def recording(stamps: Optional["Stamps"]):
    """``stamp`` writes into ``stamps`` on this thread meanwhile (with
    None, stamps nothing)."""
    outer = getattr(_local, "stamps", None)
    _local.stamps = stamps
    try:
        yield stamps
    finally:
        _local.stamps = outer


def _lib():
    from omnia_tpu_torch import kernels

    lib = kernels.load("stamps")
    if lib.omnia_stamp.argtypes is None:
        lib.omnia_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.omnia_stamp.restype = ctypes.c_int
    return lib


def region_masks(labels: list) -> dict:
    """Which of the intervals between a step's stamps (interval j runs
    from stamp j to stamp j + 1) each region sums."""
    lab = np.array(labels[:-1])
    moe = np.zeros(len(lab), bool)
    start = None
    for j, label in enumerate(list(lab) + ["attn"]):
        if label == "ffn":
            start = j
        elif label in ("attn", "head") and start is not None:
            # One layer's ln2 to its residual add: a MoE layer if it
            # holds the experts.
            moe[start:j] = "experts" in lab[start:j]
            start = None
    ffn = np.isin(lab, ("ffn", "experts", "route"))
    return {"attn": lab == "attn", "ffn": ffn, "experts": lab == "experts",
            "moe_route": moe & ffn & (lab != "experts"), "head": lab == "head"}


class Stamps:
    """One decode chunk's stamps: row i holds its i-th step that ran (on
    the card, its i-th step: the row of a skipped step stays zero), in
    the order the step makes them; ``labels`` are the first step's,
    which every step repeats."""

    def __init__(self, steps: int, cols: int, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.data = torch.zeros((steps, cols), dtype=torch.int64, device=device)
        self.labels: list = []
        self._row = self._col = 0
        self._masks: Optional[dict] = None
        self._launch = _lib().omnia_stamp if self.cuda else None

    def stamp(self, label: str) -> None:
        row, col = self._row, self._col
        steps, cols = self.data.shape
        if row >= steps or col >= cols:
            raise RuntimeError(f"a decode chunk's stamps overflow [{steps}, {cols}] at "
                               f"[{row}, {col}] ({label!r})")
        if row == 0:
            self.labels.append(label)
        elif col >= len(self.labels) or self.labels[col] != label:
            raise RuntimeError(f"step {row} stamps {label!r} at {col}, step 0 stamped "
                               f"{self.labels[col] if col < len(self.labels) else None!r}")
        if self.cuda:
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self._launch(stream, self.data.data_ptr() + 8 * (row * cols + col))
            if err != 0:
                raise RuntimeError(f"the stamp kernel's launch failed: cudaError {err}")
        else:
            self.data[row, col] = time.perf_counter_ns()
        if label == "end":
            self._row, self._col = row + 1, 0
        else:
            self._col = col + 1

    def steps(self, data: np.ndarray) -> np.ndarray:
        """The stamps of the steps that ran, [steps, len(labels)]."""
        return data[data[:, 0] != 0, :len(self.labels)]

    def split(self, data: np.ndarray) -> tuple[int, dict]:
        """(steps that ran, each region's ns summed over them) from a
        host copy of ``data``."""
        ran = self.steps(data)
        if len(ran) == 0 or len(self.labels) < 2:
            return len(ran), dict.fromkeys(REGIONS, 0)
        if self._masks is None:
            self._masks = region_masks(self.labels)
        spans = np.diff(ran, axis=1).sum(axis=0)
        return len(ran), {r: int(spans[m].sum()) for r, m in self._masks.items()}


class ChunkTiming:
    """One dispatched decode chunk's event pair and stamps, until its read."""

    __slots__ = ("e0", "e1", "stamps", "host", "toks", "after_placement")

    def __init__(self, e0, stamps: Stamps, after_placement: bool):
        self.e0, self.e1 = e0, None
        self.stamps = stamps
        self.host: Optional[torch.Tensor] = None
        self.toks = None
        self.after_placement = after_placement

    def copy_out(self) -> None:
        """Enqueue the stamps' copy to pinned memory (on the card); the
        chunk's token event then covers it."""
        if self.stamps.cuda:
            data = self.stamps.data
            self.host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
            self.host.copy_(data, non_blocking=True)

    def host_data(self) -> np.ndarray:
        return (self.host if self.host is not None else self.stamps.data).numpy()


class Timeline:
    """The engine's device timeline, kept with the flight recorder on.

    ``flight`` is the engine's recorder: a program's device interval is
    added to its ``prefill_piece`` event once resolved."""

    def __init__(self, device: torch.device, num_layers: int, flight):
        self.device = device
        self.cuda = device.type == "cuda"
        # The most stamps a step makes: two a layer, two more inside a MoE
        # layer, and the head's two.
        self.cols = 4 * num_layers + 2
        self._flight = flight
        self._anchor: Optional[tuple] = None          # (event, wall ns)
        self._last_end = None                         # the last read chunk's end mark
        self._after_placement = False
        self._programs: deque = deque()               # (start, end, flight event)
        # The chunk _run_decode_step enqueued last, until _push_inflight takes it.
        self.pending: Optional[ChunkTiming] = None
        self.anchor()

    # -- marks ------------------------------------------------------------

    def _event(self):
        """A timing CUDA event recorded now on the current stream, or the
        host's ns on the CPU."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter_ns()

    @staticmethod
    def _ns(a, b) -> int:
        """Device ns from event ``a`` to event ``b``."""
        if isinstance(a, int):
            return b - a
        return round(a.elapsed_time(b) * 1e6)

    def mark(self) -> tuple:
        """A point on the device's timeline, recorded now on the current
        stream: (the anchor that places it on the wall clock, its event)."""
        if (time.time_ns() - self._anchor[1] >= REANCHOR_NS
                and (not self.cuda or torch.cuda.current_stream(self.device).query())):
            self.anchor()
        return self._anchor, self._event()

    def between(self, m0: tuple, m1: tuple) -> int:
        """Device ns from mark ``m0`` to mark ``m1``."""
        return self._ns(m0[1], m1[1])

    def _done(self, m: tuple) -> bool:
        return m[1].query() if self.cuda else True

    def anchor(self) -> None:
        """Tie the device's timeline to the wall clock: on an idle stream
        an event lands between the host's reads of ``time.time_ns()``
        before its record and after its wait, and the window's midpoint
        is its wall time to half the window. Up to ``ANCHOR_TRIES``
        events, until one's window is at most ``ANCHOR_WINDOW_NS``; where
        none is (the host thread was held up), the last anchor stays, once
        there is one."""
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()
        best = None
        for _ in range(ANCHOR_TRIES):
            t0 = time.time_ns()
            ev = self._event()
            if self.cuda:
                ev.synchronize()
            t1 = time.time_ns()
            if best is None or t1 - t0 < best[2]:
                best = (ev, (t0 + t1) // 2, t1 - t0)
            if best[2] <= ANCHOR_WINDOW_NS:
                break
        if self._anchor is None or best[2] <= ANCHOR_WINDOW_NS:
            self._anchor = best[:2]

    def wall_ns(self, m: tuple) -> int:
        (ev, wall), e = m
        return wall + self._ns(ev, e)

    # -- decode chunks ----------------------------------------------------

    def stamps_for(self, steps: int) -> Stamps:
        return Stamps(steps, self.cols, self.device)

    def begin_chunk(self, stamps: Stamps) -> ChunkTiming:
        """The start of a decode chunk about to be enqueued."""
        timing = ChunkTiming(self.mark(), stamps, self._after_placement)
        self._after_placement = False
        return timing

    def end_chunk(self, timing: ChunkTiming, toks) -> None:
        """The chunk is enqueued; its tokens ``toks`` go to _push_inflight."""
        timing.e1 = self.mark()
        timing.toks = toks
        self.pending = timing

    def take(self, toks) -> Optional[ChunkTiming]:
        """The timing of the chunk whose tokens are ``toks``, if it is the
        one enqueued last (a mixed step's tokens have none)."""
        timing, self.pending = self.pending, None
        if timing is None or timing.toks is not toks:
            return None
        timing.toks = None
        return timing

    def resolve(self, timing: ChunkTiming, metrics: dict) -> dict:
        """At the chunk's read (its event has completed): the counters
        advance, and the chunk's flight attributes are returned."""
        steps, regions = timing.stamps.split(timing.host_data())
        metrics["decode_timed_steps"] += steps
        metrics["decode_chunk_device_ns"] += self.between(timing.e0, timing.e1)
        for r in COUNTED:
            metrics[f"decode_{r}_ns"] += regions[r]
        if self._last_end is not None:
            gap = self.between(self._last_end, timing.e0)
            metrics["decode_gap_ns"] += gap
            if timing.after_placement:
                metrics["decode_gap_placement_ns"] += gap
        self._last_end = timing.e1
        t0, t1 = self.wall_ns(timing.e0), self.wall_ns(timing.e1)
        if self._ns(self._anchor[0], timing.e1[1]) > REBASE_NS:
            self._anchor = (timing.e1[1], t1)
        self._resolve_programs()
        return {"dev_t0_ns": t0, "dev_t1_ns": t1, "steps_ran": steps,
                **{f"{r}_ns": v for r, v in regions.items()}}

    def idle(self) -> None:
        """No slot is active and nothing is in flight: the next chunk's
        start is no gap."""
        self._last_end = None

    def reset(self) -> None:
        """A recovery dropped the chunks in flight."""
        self._last_end = self.pending = None
        self._after_placement = False
        self._programs.clear()

    # -- placement programs -----------------------------------------------

    def program(self, start, event) -> None:
        """A prefill, extend or insert program was enqueued after the
        mark ``start``; ``event`` is its flight event, or None."""
        self._programs.append((start, self.mark(), event))
        self._after_placement = True
        self._resolve_programs()

    def _resolve_programs(self) -> None:
        while self._programs and self._done(self._programs[0][1]):
            start, end, event = self._programs.popleft()
            if event is not None:
                self._flight.note_device_interval(event, self.wall_ns(start),
                                                  self.wall_ns(end))

"""The captured ring decode chunk (the card's edition of the ring decode
programs of ``omnia_tpu/engine/programs.py``, which JAX compiles with
``jax.jit`` into one program per chunk size).

On the card an engine with ``decode_ring > 0`` serves every decode chunk
by replaying one ``torch.cuda.CUDAGraph`` per entry of
``EngineConfig.chunk_variants()``, all captured into one memory pool.
The engine captures them all at once, on its current state, where it
first needs them (``_ring``): at warmup's first decode task and again at
the end of its restore, at a recovery, or at the first dispatch of an
engine that was never warmed. There is no eager fallback: a capture that
fails raises. The engine's other capture site is the fresh prefill's
(``prefill_graphs.py``, ``_prefill_graphs``), whose graphs live and die
beside these, in a memory pool of their own.

- **Fixed buffers.** A graph reads and writes the engine's own state
  tensors in place: tokens, positions, active, budget, key_data and
  gstate; it reads stop_ids, temp, top_p, top_k, gtable, gactive, geos,
  the KV caches (and a paged cache's table) and the weights where they
  lie. The deadline-step budget ``dl`` is the graph set's own buffer,
  written by a non-blocking copy before each replay. So the engine
  never rebinds those tensors while the graphs live: placement writes
  into them in place, and the eager programs' outputs are copied into
  them (``_SchedulerMixin._adopt_decode_state``). Whatever reallocates
  them (``_init_device_state``: recovery, warmup's restore) captures the
  graphs again on the new state.
- **The early-out.** Step i of a chunk of k is an IF node whose
  predicate is ``active.any()`` over the whole batch, computed on the
  card by the node's setter (``csrc/graph_cond.cu``). Under dp, JAX's
  ``active`` spans every shard: before each node the capture stream
  all-reduces the shard's flag (a one-element int32, MAX) over dp, and
  the node reads that buffer, so a shard whose slots are done still
  steps while another shard is live (each step advances every slot's
  sampler counter). tp and sp ranks hold equal flags and take no
  collective for it. Before the node the step's row of the graph's ``[k,
  B]`` token output is set to the current tokens, so a skipped step
  outputs the frozen vector, as JAX's dead branch does. The body writes
  the sampled tokens over that row. A replay runs no Python, so each
  decode-attention launch in a body counts itself on the card
  (``ops/decode_attention.launches``): a skipped body counts nothing.
- **Collectives inside the graph** (tp, dp; one rank per card over
  NCCL, ``engine.validate_parallel``). The body's collectives (over tp
  the SUM after ``wo`` and ``wd`` and the samplers' logits gather, over
  dp an MoE layer's counts from 64 global rows) are ``Comm``'s own calls
  through PyTorch's ``ProcessGroupNCCL``, captured where they are
  called: PyTorch's NCCL stream joins the body's capture through its
  event wait, and NCCL captures its kernel into the body graph; no
  direct ``ncclAllReduce`` on the body stream is needed. Two conditions
  hold them there. NCCL's graph mixing must be off
  (``NCCL_GRAPH_MIXING_SUPPORT=0``, set by the job; the engine refuses
  the ring without it): with it on NCCL adds event record and wait
  nodes, which a conditional body refuses (the capture's end fails with
  ``cudaErrorInvalidValue``; NCCL 2.28.9, H100s, two ranks,
  ``tests/nccl_graph_probe.py``).
  And with it off a communicator must not take an uncaptured call while
  a graph launch is outstanding, so the captured collectives run on
  communicators of their own (``parallel/mesh.py::capture_comms``),
  which after the warm step below see only replays, one after another
  on the engine's stream. A replay launches them without Python, so
  ``Comm``'s counts see the capture only; ``step_collectives`` records
  one captured step's calls and bytes per axis. B is the shard's: the
  caller gathers the replay's ``[k, B]`` tokens over dp after it,
  outside the graph, on the engine's own dp communicator.
- **Streams and memory.** The capture runs on a stream of its own and
  each body on another (created once per device by the helper library:
  PyTorch's pool may hand two of its streams out as one). Allocations of
  the capture stream go to the graphs' pool; the bodies' allocations,
  which PyTorch's capture does not route, go to a second pool of their
  own, routed by thread. One eager step on the body stream before the
  first capture loads the kernels, sizes the decode-attention scratch,
  gives cuBLAS its workspace outside any pool and makes the captured
  collectives' NCCL communicators.
- **Region stamps** (the engine's timeline, with the flight recorder
  on; ``utils/timeline.py``). The chunks are captured with the timeline's
  recorder set, so each step's stamps (one-thread kernels of
  ``csrc/stamps.cu``) are kernel nodes of its IF body, writing row i of
  the chunk's own stamp buffer, which a memset node at the graph's head
  zeroes: a skipped step leaves its row zero. The warm step runs them
  once eagerly, into a scratch buffer. Without the timeline the graphs
  hold none of these nodes.
- **Output.** A replay leaves the chunk's tokens in the graph's output
  buffer, which the next replay of that graph overwrites: the caller
  enqueues the copy to the host right after the replay (``_InflightChunk``).
- **Lifetime.** A graph keeps the decode-attention scratch buffer it
  captured, which the scratch's later growth would otherwise free, and
  its predicates' buffers.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from omnia_tpu_torch import kernels
from omnia_tpu_torch.ops import decode_attention
from omnia_tpu_torch.parallel.collectives import all_reduce_max
from omnia_tpu_torch.utils.timeline import recording

_SOURCE = "graph_cond"
_STREAMS: dict[int, tuple] = {}
_STREAMS_LOCK = threading.Lock()
# The deadline-step budget of a slot without a deadline: effectively
# infinite (the JAX engine's value).
NO_DEADLINE = 1 << 30


def _lib():
    lib = kernels.load(_SOURCE)
    if lib.omnia_graph_if_begin.argtypes is None:
        # Pointers and streams as c_void_p, or ctypes cuts them to 32 bits.
        lib.omnia_graph_if_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p]
        lib.omnia_graph_if_end.argtypes = [ctypes.c_void_p]
        lib.omnia_stream_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        for fn in (lib.omnia_graph_if_begin, lib.omnia_graph_if_end, lib.omnia_stream_create):
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _streams(device: torch.device) -> tuple:
    """(capture stream, body stream) of a device, made once: the cuBLAS
    workspace PyTorch keeps per stream then serves every capture."""
    with _STREAMS_LOCK:
        pair = _STREAMS.get(device.index)
        if pair is None:
            made = []
            for _ in range(2):
                ptr = ctypes.c_void_p()
                with torch.cuda.device(device):
                    _check(_lib().omnia_stream_create(ctypes.byref(ptr)), "cudaStreamCreate")
                made.append(torch.cuda.ExternalStream(ptr.value, device=device))
            pair = _STREAMS[device.index] = tuple(made)
    return pair


class RingGraphs:
    """One captured ring chunk per chunk size over one engine state.

    ``step`` is the programs' ``_step``; ``state`` the engine's (tokens,
    positions, active, budget, key_data, gstate-or-None) at the shard's
    B; ``inputs`` the read-only operands (params, ck, cv, stop_ids, temp,
    top_p, top_k, g = () or (gtable, gactive), geos-or-None); ``comms``
    the Comms by axis name that ``step`` runs its collectives on (the
    engine's ``capture_comms``; their counts give ``step_collectives``),
    "dp" among them for the predicate's OR; ``timeline`` the engine's
    ``Timeline``, whose region stamps the steps then carry, or None."""

    def __init__(self, step: Callable, state: tuple, inputs: dict, device: torch.device,
                 comms: Optional[dict] = None, timeline=None):
        self._step = step
        self._state = state
        self._inputs = inputs
        self._comms = {k: c for k, c in (comms or {}).items() if c is not None}
        self._dp = self._comms.get("dp")
        self.device = torch.device("cuda", device.index if device.index is not None
                                   else torch.cuda.current_device())
        self.num_slots = state[0].shape[0]
        self.dl = torch.full((self.num_slots,), NO_DEADLINE, dtype=torch.int32, device=device)
        self._pool = torch.cuda.graph_pool_handle()
        self._body_pool = torch.cuda.MemPool()
        self._graphs: dict[int, tuple] = {}
        # Per chunk size: the capture's seconds and the device bytes it
        # added to the pools (which every chunk size shares).
        self.capture_s: dict[int, float] = {}
        self.pool_bytes: dict[int, int] = {}
        # One captured step's collectives per axis, {axis: {"calls",
        # "bytes", "ops": {op: calls}}}: the predicate's OR (every step)
        # and the body's (the steps that run). Replays are not in the
        # Comms' own counts.
        self.step_collectives: dict = {}
        self._timeline = timeline
        self._warm = False

    def _tallies(self) -> dict:
        return {axis: (c.stats["calls"], c.stats["bytes"],
                       {op: st["calls"] for op, st in c.op_stats.items()})
                for axis, c in self._comms.items()}

    def _count_step(self, before: dict) -> None:
        if self.step_collectives:
            return
        after = self._tallies()
        self.step_collectives = {
            axis: {"calls": after[axis][0] - calls, "bytes": after[axis][1] - nbytes,
                   "ops": {op: n - ops.get(op, 0) for op, n in after[axis][2].items()
                           if n > ops.get(op, 0)}}
            for axis, (calls, nbytes, ops) in before.items() if after[axis][0] > calls}

    def _predicate(self) -> tuple:
        """(flags, bytes) the step's IF node reads: the slots' active flags,
        or under dp their OR over the shards (a one-element int32)."""
        active = self._state[2]
        if self._dp is None:
            return active, self.num_slots
        flag = all_reduce_max(active.any().to(torch.int32).reshape(1), self._dp)
        return flag, flag.element_size()

    def _body(self, toks_row) -> None:
        """One ring step, written into the fixed buffers."""
        i = self._inputs
        new, tok = self._step(i["params"], i["ck"], i["cv"], self._state + (self.dl,),
                              i["stop_ids"], i["temp"], i["top_p"], i["top_k"], i["g"],
                              i["geos"])
        for dst, src in zip(self._state + (self.dl,), new):
            if dst is not None:
                dst.copy_(src)
        toks_row.copy_(tok)

    def _warmup(self, body_stream) -> None:
        """One eager step, predicate included, on the body stream before the
        first capture: NCCL makes a communicator at its first call, which
        a capture cannot hold. The state it advances is put back, so the
        KV row it writes at each slot's position is the one the next real
        step writes again."""
        fixed = [t for t in self._state + (self.dl,) if t is not None]
        saved = [t.clone() for t in fixed]
        toks = torch.empty((1, self.num_slots), dtype=torch.int32, device=self.device)
        body_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(body_stream), recording(self._new_stamps(1)):
            self._predicate()
            self._body(toks[0])
        torch.cuda.current_stream(self.device).wait_stream(body_stream)
        for t, v in zip(fixed, saved):
            t.copy_(v)
        torch.cuda.synchronize(self.device)
        self._warm = True

    def _new_stamps(self, k: int):
        """A fresh stamp buffer of ``k`` steps, or None without the timeline."""
        return None if self._timeline is None else self._timeline.stamps_for(k)

    def capture(self, k: int) -> None:
        """Capture (again) the chunk of ``k`` steps."""
        lib = _lib()
        cap, body = _streams(self.device)
        if not self._warm:
            self._warmup(body)
        torch.cuda.synchronize(self.device)
        self._graphs.pop(k, None)   # its last replay has finished
        graph = torch.cuda.CUDAGraph()
        toks = torch.empty((k, self.num_slots), dtype=torch.int32, device=self.device)
        tokens = self._state[0]
        flags = []   # the predicates' buffers, held while the graph lives
        stamps = self._new_stamps(k)
        # An engine freed by the cycle collector mid-capture would free
        # device memory, which a capturing thread may not: collect now and
        # hold the collector off until the capture ends. The capture
        # empties the allocator's cache first; empty it now so that what
        # the reserved bytes gain is the pools' new memory.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.monotonic()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=cap,
                                  capture_error_mode="thread_local"), recording(stamps):
                if stamps is not None:
                    stamps.data.zero_()
                for i in range(k):
                    toks[i].copy_(tokens)
                    before = self._tallies()
                    flag, nbytes = self._predicate()
                    flags.append(flag)
                    _check(lib.omnia_graph_if_begin(cap.cuda_stream, flag.data_ptr(), nbytes,
                                                    body.cuda_stream),
                           "the IF node's capture")
                    try:
                        with torch.cuda.stream(body), torch.cuda.use_mem_pool(
                                self._body_pool, self.device):
                            self._body(toks[i])
                    finally:
                        _check(lib.omnia_graph_if_end(body.cuda_stream),
                               "the IF body's capture")
                    self._count_step(before)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s[k] = time.monotonic() - t0
        self.pool_bytes[k] = torch.cuda.memory_reserved(self.device) - reserved
        self._graphs[k] = (graph, toks, decode_attention.scratch_buffer(self.device), flags,
                           stamps)

    def stamps(self, k: int):
        """The chunk of ``k`` steps' stamp buffer (``Stamps``), which each
        replay writes; None without the timeline."""
        return self._graphs[k][4]

    def replay(self, k: int, dl_steps: np.ndarray) -> torch.Tensor:
        """Enqueue the chunk of ``k`` steps with the deadline-step budget
        ``dl_steps`` int32 [B]. Returns its token output [k, B], unread."""
        graph, toks = self._graphs[k][:2]
        self.dl.copy_(torch.from_numpy(np.ascontiguousarray(dl_steps, np.int32)).pin_memory(),
                      non_blocking=True)
        graph.replay()
        return toks

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
fails raises.

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
  predicate is ``active.any()``, computed on the card by the node's
  setter (``csrc/graph_cond.cu``). Before the node the step's row of the
  graph's ``[k, B]`` token output is set to the current tokens, so a
  skipped step outputs the frozen vector, as JAX's dead branch does. The
  body writes the sampled tokens over that row. A replay runs no Python,
  so each decode-attention launch in a body counts itself on the card
  (``ops/decode_attention.launches``): a skipped body counts nothing.
- **Streams and memory.** The capture runs on a stream of its own and
  each body on another (created once per device by the helper library:
  PyTorch's pool may hand two of its streams out as one). Allocations of
  the capture stream go to the graphs' pool; the bodies' allocations,
  which PyTorch's capture does not route, go to a second pool of their
  own, routed by thread. One eager step on the body stream before the
  first capture loads the kernels, sizes the decode-attention scratch
  and gives cuBLAS its workspace outside any pool.
- **Output.** A replay leaves the chunk's tokens in the graph's output
  buffer, which the next replay of that graph overwrites: the caller
  enqueues the copy to the host right after the replay (``_InflightChunk``).
- **Lifetime.** A graph keeps the decode-attention scratch buffer it
  captured, which the scratch's later growth would otherwise free.
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable

import numpy as np
import torch

from omnia_tpu_torch import kernels
from omnia_tpu_torch.ops import decode_attention

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
    positions, active, budget, key_data, gstate-or-None); ``inputs`` the
    read-only operands (params, ck, cv, stop_ids, temp, top_p, top_k,
    g = () or (gtable, gactive), geos-or-None)."""

    def __init__(self, step: Callable, state: tuple, inputs: dict, device: torch.device):
        self._step = step
        self._state = state
        self._inputs = inputs
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
        self._warm = False

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
        """One eager step on the body stream, before the first capture. The
        state it advances is put back, so the KV row it writes at each
        slot's position is the one the next real step writes again."""
        fixed = [t for t in self._state + (self.dl,) if t is not None]
        saved = [t.clone() for t in fixed]
        toks = torch.empty((1, self.num_slots), dtype=torch.int32, device=self.device)
        body_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(body_stream):
            self._body(toks[0])
        torch.cuda.current_stream(self.device).wait_stream(body_stream)
        for t, v in zip(fixed, saved):
            t.copy_(v)
        torch.cuda.synchronize(self.device)
        self._warm = True

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
        tokens, active = self._state[0], self._state[2]
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
                                  capture_error_mode="thread_local"):
                for i in range(k):
                    toks[i].copy_(tokens)
                    _check(lib.omnia_graph_if_begin(cap.cuda_stream, active.data_ptr(),
                                                    self.num_slots, body.cuda_stream),
                           "the IF node's capture")
                    try:
                        with torch.cuda.stream(body), torch.cuda.use_mem_pool(
                                self._body_pool, self.device):
                            self._body(toks[i])
                    finally:
                        _check(lib.omnia_graph_if_end(body.cuda_stream),
                               "the IF body's capture")
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s[k] = time.monotonic() - t0
        self.pool_bytes[k] = torch.cuda.memory_reserved(self.device) - reserved
        self._graphs[k] = (graph, toks, decode_attention.scratch_buffer(self.device))

    def replay(self, k: int, dl_steps: np.ndarray) -> torch.Tensor:
        """Enqueue the chunk of ``k`` steps with the deadline-step budget
        ``dl_steps`` int32 [B]. Returns its token output [k, B], unread."""
        graph, toks, _scratch = self._graphs[k]
        self.dl.copy_(torch.from_numpy(np.ascontiguousarray(dl_steps, np.int32)).pin_memory(),
                      non_blocking=True)
        graph.replay()
        return toks

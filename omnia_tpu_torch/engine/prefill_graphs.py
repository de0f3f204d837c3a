"""The captured fresh prefill: ``programs.prefill_insert`` replayed as one
``torch.cuda.CUDAGraph`` per prefill bucket (the JAX package compiles it
with ``jax.jit`` into one program per bucket).

Eagerly the prefill is some thousands of launches (about 120 a dense
layer, 180 a MoE layer, and some 290 more), which the host enqueues one
by one while the decode batch waits behind them. A replay is one launch
after a few copies into the graph's operands, so a placement holds the
batch for the prefill's device time alone.

- **Where.** The engine captures them (``InferenceEngine._prefill_graphs``)
  on the card with the decode ring on, on one rank (no tp, dp or sp
  communicator) and a contiguous cache (bf16, f32 or int8 rows). Every
  other engine runs the eager program: ring off, the CPU, a mesh, a
  paged cache. The engine calls ``_prefill_insert_fn`` either way, which
  replays where the bucket has a graph and the call is on the state the
  graphs captured, and runs the eager program otherwise.
- **When.** All usable buckets at once, largest first, on the current
  state: at the end of warmup's restore, at a recovery, or at the first
  fresh prefill of an engine that was never warmed. Whatever reallocates
  the state (``_init_device_state``) drops them beside the ring's
  graphs, after a synchronise. A capture that fails raises; nothing
  falls back. Captures run outside the timeline's recording, so a
  prefill stamps nothing.
- **Fixed buffers.** Per bucket the tokens and positions ``[1, b]``;
  shared by the buckets the slot and the last real row (device indices,
  int64 [1]), the sampler's key data [2], temperature, top-p and top-k
  [1], and the grammar's start-state bias [V] where grammar is on. The
  program writes the KV chunk into the slot's rows [0, b) through a
  device-indexed write (``kv_quant.cache_put_slot``) and samples the
  last row through a device-indexed gather, so one graph serves every
  slot. Weights and caches are read where they lie: the engine never
  rebinds them while the graphs live.
- **Streams and memory.** Each bucket runs once eagerly on the capture
  stream before its capture, on a one-slot scratch cache (never the
  live one): it loads the kernels and gives cuBLAS that stream's
  workspace outside the pool. The graphs share one memory pool of their
  own, apart from the ring's; the largest bucket is captured first and
  the others reuse its blocks. A replay runs on the caller's current
  stream, so the event pairs around it (the timeline's, a benchmark's)
  bracket it as they bracketed the eager launches.
- **Output.** The first token and the new key data are copied out of
  the graph's output buffers before ``replay`` returns: the next replay
  overwrites them.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch


class PrefillGraphs:
    """One captured fresh prefill per bucket over one engine state.

    ``program`` is ``programs.prefill_insert``; ``params``, ``ck``, ``cv``
    the engine's weights and caches; ``sampler`` example operands of the
    first-token sampler (key data [2], temperature, top-p, top-k [1], and
    the grammar bias [V] where grammar is on), whose shapes and dtypes the
    graphs' own buffers take."""

    def __init__(self, program: Callable, params, ck, cv, device: torch.device,
                 sampler: tuple):
        self._program = program
        self.params, self.ck, self.cv = params, ck, cv
        self.device = device
        self.slot = torch.zeros(1, dtype=torch.int64, device=device)
        self.last = torch.zeros(1, dtype=torch.int64, device=device)
        self.sampler = tuple(torch.zeros_like(t) for t in sampler)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        # Per bucket: (graph, tokens, positions, (first token, new key data)).
        self._graphs: dict[int, tuple] = {}
        # Per bucket: the capture's seconds, the warm run's included.
        self.capture_s: dict[int, float] = {}
        # The device bytes the captures added to the pool, all buckets.
        self.pool_bytes = 0

    def serves(self, params, ck, cv, bucket: int) -> bool:
        """Whether a call on (params, ck, cv) at ``bucket`` replays."""
        return (bucket in self._graphs and ck is self.ck and cv is self.cv
                and params is self.params)

    def _run(self, ck, cv, toks, pos):
        return self._program(self.params, ck, cv, toks, pos, self.slot, self.last,
                             *self.sampler)

    def capture(self, buckets, scratch_kv: Callable) -> None:
        """Capture every bucket of ``buckets``, largest first.
        ``scratch_kv(rows)`` makes a one-slot (ck, cv) of ``rows`` rows in
        the engine's representation, for the warm runs."""
        dev = self.device
        order = sorted(buckets, reverse=True)
        if not order:
            return
        # The graphs' operands, made on the caller's stream, which replays.
        inputs = {b: (torch.zeros((1, b), dtype=torch.int32, device=dev),
                      torch.arange(b, dtype=torch.int32, device=dev)[None]) for b in order}
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            sk, sv = scratch_kv(order[0])
            self.slot.zero_()
            for b in order:
                t0 = time.monotonic()
                toks, pos = inputs[b]
                self.last.fill_(b - 1)
                self._run(sk, sv, toks, pos)
                graph = torch.cuda.CUDAGraph()
                # An engine freed by the cycle collector mid-capture would
                # free device memory, which a capturing thread may not:
                # hold the collector off until the capture ends.
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                          capture_error_mode="thread_local"):
                        out = self._run(self.ck, self.cv, toks, pos)
                finally:
                    if collecting:
                        gc.enable()
                self._graphs[b] = (graph, toks, pos, out)
                self.capture_s[b] = time.monotonic() - t0
            del sk, sv
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def replay(self, tokens, positions, slot: int, last_idx: int, *sampler) -> tuple:
        """Enqueue the prefill of ``tokens``' bucket into slot ``slot`` on
        the current stream, its first token sampled at row ``last_idx``
        with ``sampler``'s operands → (first token 0-d int32, new key data
        [2]), copies of the graph's outputs."""
        graph, toks, pos, (tok, kd) = self._graphs[tokens.shape[1]]
        toks.copy_(tokens)
        pos.copy_(positions)
        self.slot.fill_(slot)
        self.last.fill_(last_idx)
        for dst, src in zip(self.sampler, sampler):
            dst.copy_(src)
        graph.replay()
        return tok.clone(), kd.clone()

"""Continuous-batching inference engine (port of
``omnia_tpu/engine/engine.py::InferenceEngine`` for a dense, sessionful
configuration; the KV cache is contiguous or paged, in the model's dtype
or int8; the weights in the model's dtype or int8, ``EngineConfig.quant``).

- **Slot batching.** Decode runs over a fixed batch of ``num_slots``
  sequences; requests claim and free slots as they arrive and finish.
  Inactive slots still compute (a fixed batch), and admission reclaims
  them.
- **Prefill, then decode.** A fresh prompt prefills in its bucket and is
  written into its slot's rows; a longer one, or a session turn past its
  cached prefix, extends in bucket-sized pieces. Decode never sees prompt
  shapes.
- **Sessions.** With ``submit(..., session_id=...)`` a conversation's
  rows outlive its requests: the next turn prefills only the tokens past
  the longest common prefix, idle sessions beyond the slots page to host
  RAM and back, and ``export_session`` / ``import_session`` move one to
  another engine in the JAX engine's host-row format.
- **Shared prefixes** (``prefix_cache_slots > 0``): a prefix seen often
  enough, or registered by ``register_prefix`` (a pack's system block),
  is kept in a pool, and a fresh session seeds its rows from there
  instead of prefilling them (``prefix_cache.py``).
- **Grammars** (``grammar=True``): ``submit(..., grammar=g)`` masks every
  sampled token with g's FSM, on the device.
- **Stall-free batching** (``prefill_chunk_tokens > 0``): an arriving
  prompt is fed in pieces, each fused with one decode step of the batch
  (``interleave.py``).
- **Speculative decoding** (``spec_decode > 0``): greedy slots verify
  prompt-lookup proposals in one [B, W+1] forward (``spec_decode.py``).
- **Terminals in the caller's enum.** ``finish_reasons`` names the enum
  class final events carry (the JAX package's, for its runtime and
  coordinator); by default the port's own.
- **Operations** (``warmup.py``, ``coldstart.py``, ``flight.py``,
  ``faults.py``, ``devloop.py``): warmup runs every program shape before
  readiness, in order (``warmup_threads > 0`` only overlaps the
  param-free tasks with the weights loader); a ``coldstart=`` tracker records the bring-up
  phases; ``flight_events > 0`` keeps a ring of lifecycle events and
  per-request latency breakdowns; ``watchdog_s`` bounds a decode chunk's
  host read, and a trip fails the requests in flight and reallocates the
  device state.
- **The decode ring** (``decode_ring >= 2``, ``devloop.py``): the decode
  chunk's ring edition (a deadline-step budget, per-slot grammar EOS, an
  all-done early-out), replayed on the card as one captured CUDA graph
  per chunk size (``graphs.py``), with each chunk's read started on the
  drainer thread at dispatch while the ring's self-gate allows it.
- **Everything stays on the device.** Sampled tokens feed the next step
  as device tensors; only each chunk's int32 ``[K, num_slots]`` tokens
  cross to the host, for streaming and stop logic.
- **Per-slot sampler state** makes a seeded request reproducible whatever
  shares the batch (``ops/sampling.py``).

Layout mirrors the JAX package: programs in ``programs.py``, the
dispatch policy in ``scheduler.py``, the token-budget policy in
``interleave.py``, speculation in ``spec_decode.py``, placement in ``placement.py``,
session residency in ``sessions.py``, the shared-prefix pool in
``prefix_cache.py``, the thread lifecycle in ``lifecycle.py``, the page
pool's books in ``paged.py``, warmup in ``warmup.py``; this module owns
construction and submission.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from omnia_tpu_torch import resolve_device
from omnia_tpu_torch.engine.coldstart import PHASE_CODES, ColdStartTracker, build_cache_dir
from omnia_tpu_torch.engine.devloop import DevLoopState, validate_decode_ring
from omnia_tpu_torch.engine.faults import FaultPlan
from omnia_tpu_torch.engine.flight import FlightRecorder
from omnia_tpu_torch.engine.interleave import _InflightPrefill, _InterleaveMixin
from omnia_tpu_torch.engine.lifecycle import _LifecycleMixin
from omnia_tpu_torch.engine.paged import _PagedKVMixin, validate_paged_config
from omnia_tpu_torch.engine.grammar import stats as grammar_cache_stats
from omnia_tpu_torch.engine.graphs import RingGraphs
from omnia_tpu_torch.engine.placement import _PlacementMixin
from omnia_tpu_torch.engine.prefix_cache import PrefixPool, _PrefixCacheMixin
from omnia_tpu_torch.engine.programs import build_programs
from omnia_tpu_torch.engine.scheduler import _SchedulerMixin
from omnia_tpu_torch.engine.sessions import _SessionKV, _SessionMixin, _Slot
from omnia_tpu_torch.engine.spec_decode import _SpecDecodeMixin, validate_spec_config
from omnia_tpu_torch.engine.warmup import _WarmupMixin
from omnia_tpu_torch.engine.types import (
    MAX_DEVICE_STOP_IDS,
    EngineConfig,
    FinishReason,
    Request,
    RequestHandle,
    SamplingParams,
    resolve_dtype,
)
from omnia_tpu_torch.models import ModelConfig, llama, quant
from omnia_tpu_torch.models.kv_quant import cache_bytes, validate_kv_quant
from omnia_tpu_torch.ops.decode_attention import edition
from omnia_tpu_torch.ops.sampling import make_slot_key_data
from omnia_tpu_torch.parallel.mesh import make_mesh
from omnia_tpu_torch.parallel.sharding import shard_pytree

logger = logging.getLogger(__name__)

# Knobs this port does not implement yet: (field, ROADMAP item). Set
# away from its default, each one is refused at construction.
_UNPORTED_KNOBS = (("dp", "A13"), ("sp", "A13"))


def _refuse_unported(ecfg: EngineConfig) -> None:
    default = EngineConfig()
    for field, item in _UNPORTED_KNOBS:
        value = getattr(ecfg, field)
        if value != getattr(default, field):
            raise ValueError(
                f"EngineConfig.{field}={value!r} is not ported to "
                f"omnia_tpu_torch yet (ROADMAP {item})"
            )


def validate_tp(ecfg: EngineConfig, mcfg: ModelConfig) -> None:
    """Refuse a tensor-parallel engine that cannot run: the ring under tp
    (ROADMAP A16), a degree that does not divide what it splits (the JAX
    package's "tp divides num_kv_heads", and the heads, FFN or experts
    and vocabulary), or a job that is not ``tp`` ranks of one process
    group (``parallel/distributed.py``)."""
    tp = ecfg.tp
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return
    if ecfg.decode_ring >= 2:
        raise ValueError(
            f"decode_ring={ecfg.decode_ring} with tp={tp}: the ring's CUDA graph "
            "cannot capture a gloo collective, and capturing NCCL collectives "
            "needs more than one card (ROADMAP A16)")
    split = {"num_kv_heads": mcfg.num_kv_heads, "num_heads": mcfg.num_heads,
             "vocab_size": mcfg.vocab_size}
    split.update({"num_experts": mcfg.num_experts} if mcfg.is_moe
                 else {"ffn_hidden_size": mcfg.ffn_hidden_size})
    for name, n in split.items():
        if n % tp:
            raise ValueError(f"tp={tp} must divide {name}={n}")
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != tp:
        raise ValueError(
            f"EngineConfig.tp={tp} needs a torch.distributed process group of {tp} "
            f"ranks, one engine per rank (omnia_tpu_torch.parallel.distributed); "
            f"have {'none' if world is None else world}")


class InferenceEngine(_SchedulerMixin, _InterleaveMixin, _SpecDecodeMixin, _SessionMixin,
                      _PrefixCacheMixin, _PlacementMixin, _PagedKVMixin, _LifecycleMixin,
                      _WarmupMixin):
    """Slot-based continuous-batching engine over one model."""

    def __init__(self, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig = EngineConfig(),
                 params=None, seed: int = 0, device=None, finish_reasons=None,
                 coldstart: Optional[ColdStartTracker] = None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        # Bring-up phases, weight bytes and warmup progress. A caller that
        # measures the backend's bring-up (the runtime server) passes its
        # own tracker with backend_init begun; construction closes it.
        self._coldstart = coldstart or ColdStartTracker()
        # The enum class final events carry; any enum with the same
        # values (the JAX package's FinishReason) may be passed.
        self._finish_reasons = finish_reasons or FinishReason
        _refuse_unported(engine_cfg)
        validate_decode_ring(engine_cfg)
        validate_tp(engine_cfg, model_cfg)
        # Tensor parallelism: this rank's view of the tp mesh and the
        # axis's Comm, which every forward and sampler takes (None at
        # tp = 1: no collective anywhere).
        self._mesh = make_mesh(tp=engine_cfg.tp) if engine_cfg.tp > 1 else None
        self._tp = self._mesh.comm("tp") if self._mesh is not None else None
        if engine_cfg.warmup_threads < 0:
            raise ValueError("warmup_threads must be >= 0")
        self._gr_on = bool(engine_cfg.grammar)
        if self._gr_on and engine_cfg.grammar_max_states < 2:
            raise ValueError("grammar_max_states must be >= 2 with grammar on")
        if engine_cfg.max_seq > model_cfg.max_seq_len:
            raise ValueError("engine max_seq exceeds model max_seq_len")
        self._dtype = resolve_dtype(engine_cfg.dtype)
        self._kv_quant = validate_kv_quant(engine_cfg.kv_quant)
        validate_paged_config(engine_cfg)
        validate_spec_config(engine_cfg)
        self._seed = seed
        self.clock = time.monotonic
        # Cross-session shared-prefix pool: host-side books here, device
        # rows allocated with the caches (_init_device_state).
        self._prefix_pool: Optional[PrefixPool] = None
        self._pending_prefix_regs: list[list[int]] = []  # guarded-by: _lock
        if engine_cfg.prefix_cache_slots > 0:
            self._prefix_pool = PrefixPool(engine_cfg.prefix_cache_slots,
                                           engine_cfg.prefix_cache_host_entries,
                                           clock=lambda: self.clock())

        # The flight recorder (flight.py): None with flight_events = 0, so
        # every seam is one None check. It keeps its own monotonic clock,
        # never self.clock. Made before the weights load so that the
        # init phases have somewhere to land.
        self._flight: Optional[FlightRecorder] = (
            FlightRecorder(engine_cfg.flight_events) if engine_cfg.flight_events > 0 else None
        )
        # The runtime sets its tracer here: submits that carry a
        # trace_ctx then open an omnia.engine.request span (flight on).
        self.tracer = None
        # Fault injection (faults.py); None outside tests and smoke runs.
        self._fault_plan: Optional[FaultPlan] = None

        progs = build_programs(model_cfg, engine_cfg, self._tp)
        self._prefill_insert_fn = progs.prefill_insert
        self._decode_fns = progs.decode_fns
        self._step_fn = progs.step
        # The captured ring chunks (graphs.py): on the card with the ring
        # on, made by _ring where first needed on the current state; None
        # otherwise, and again whenever _init_device_state frees that state.
        self._ring_graphs: Optional[RingGraphs] = None
        self._extend_fn = progs.extend
        self._extend_nosample_fn = progs.extend_nosample
        self._offload_fn = progs.offload
        self._restore_fn = progs.restore
        self._prefix_store_fn = progs.prefix_store
        self._prefix_seed_fn = progs.prefix_seed
        self._prefix_offload_fn = progs.prefix_offload
        self._page_copy_fn = progs.page_copy
        self._gather_pages_fn = progs.gather_pages
        self._scatter_pages_fn = progs.scatter_pages
        self._verify_fn = progs.verify
        self._verify_decode_fn = progs.verify_decode
        self._mixed_fns = progs.mixed
        self._mixed_sample_fns = progs.mixed_sample
        self._mixed_spec_fns = progs.mixed_spec
        self._mixed_spec_sample_fns = progs.mixed_spec_sample

        if self.device.type == "cuda":
            # The CUDA context and the caching allocator's first block.
            torch.empty(1, device=self.device)
        backend_init_s = self._coldstart.end_phase("backend_init")
        if self._flight is not None:
            self._flight.note_init_phase("backend_init", {
                "backend": self.device.type, "seconds": backend_init_s,
            })
        self.params = self._resolve_params(params, seed)

        B = engine_cfg.num_slots
        self._slots = [_Slot() for _ in range(B)]
        self._lock = threading.Lock()
        self._waiting: list[tuple[Request, RequestHandle]] = []  # guarded-by: _lock
        self._placing = 0  # guarded-by: _lock
        self._draining = False  # guarded-by: _lock
        self._req_counter = itertools.count()
        # Session registry, engine-thread-owned; other threads' releases
        # and imports queue under _lock (engine/sessions.py).
        self._sessions: dict[str, _SessionKV] = {}
        self._pending_releases: list[str] = []  # guarded-by: _lock
        self._pending_imports: list = []  # guarded-by: _lock
        self._inflight: collections.deque = collections.deque()
        # The at most one placement mid-interleave (engine/interleave.py);
        # always None with prefill_chunk_tokens = 0.
        self._prefilling: Optional[_InflightPrefill] = None
        # The device-resident loop's host state (devloop.py): the ring and
        # the drainer behind the ring and the watchdog. None, and no
        # thread, with decode_ring = 0 and no watchdog_s.
        self._devloop: Optional[DevLoopState] = (
            DevLoopState(engine_cfg.decode_ring)
            if engine_cfg.decode_ring > 0 or engine_cfg.watchdog_s is not None else None
        )
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._healthy = True
        # The JAX engine's metric names, for what this engine does.
        self.metrics = {
            "requests_submitted": 0,
            "requests_finished": 0,
            "tokens_generated": 0,
            "prefill_steps": 0,
            "decode_steps": 0,
            "extend_steps": 0,
            "prefill_tokens": 0,
            "prefix_reuse_tokens": 0,
            "session_offloads": 0,
            "session_restores": 0,
            "session_exports": 0,
            "session_imports": 0,
            # Cross-session shared-prefix pool (engine/prefix_cache.py).
            "prefix_cache_hit_tokens": 0,
            "prefix_cache_insertions": 0,
            "prefix_cache_evictions": 0,
            "prefix_cache_host_hits": 0,
            "prefix_cache_offload_elisions": 0,
            "decode_dispatch_s": 0.0,
            "decode_sync_s": 0.0,
            "prefill_dispatch_s": 0.0,
            # Speculative decoding (spec_decode.py): acceptance rate =
            # spec_accepted / spec_proposed; gate_state is the self-gate's
            # decision (0 probing / 1 on / 2 off), accept_ema the
            # engine-wide accept-rate EMA, index_bytes the n-gram
            # indexes' estimated host bytes.
            "spec_steps": 0,
            "spec_proposed": 0,
            "spec_accepted": 0,
            "spec_gate_state": 0,
            "spec_accept_ema": 0.0,
            "spec_index_bytes": 0,
            # Stall-free batching (interleave.py): fused prefill-piece +
            # decode steps, and the prompt tokens they consumed (counted
            # per piece, so exact under a mid-prefill abort).
            "mixed_steps": 0,
            "interleaved_prefill_tokens": 0,
            "requests_shed": 0,
            "deadline_exceeded": 0,
            # Hung-dispatch watchdog firings (each one also recovers).
            "watchdog_trips": 0,
            # The decode ring (devloop.py): ring_drains = chunks whose
            # read ran on the drainer thread, ring_full_stalls =
            # dispatches that first processed the oldest chunk of a full
            # ring, early_exit_steps = ring steps skipped once every
            # slot of their chunk was done, gate_state = the self-gate
            # (0 probing / 1 on / 2 off).
            "decode_ring_enabled": 1 if engine_cfg.decode_ring > 0 else 0,
            "ring_drains": 0,
            "ring_full_stalls": 0,
            "early_exit_steps": 0,
            "decode_ring_gate_state": 0,
            "recoveries": 0,
            "decode_stall_steps": 0,
            # Grammars: compile_hits/misses read this package's compile
            # cache (a grammar compiled by another package counts in
            # that package's cache); masked_logit_fraction is the mean
            # share of the vocabulary masked per constrained step;
            # rejections_avoided counts constrained generations brought
            # to a valid stop.
            "grammar_compile_hits": 0,
            "grammar_compile_misses": 0,
            "masked_logit_fraction": 0.0,
            "grammar_rejections_avoided": 0,
            # int8 KV cache: bytes one cached token costs (k + v over all
            # layers, scales included) and the caches' real allocation,
            # the prefix pool's included.
            "kv_quant_enabled": 1 if self._kv_quant else 0,
            "kv_quant_bytes_per_token": self.kv_bytes_per_token(),
            "kv_quant_device_bytes": 0,
            # Paged KV cache: usable pages total / free, the slack inside
            # slot-held pages, and copy-on-write copies of pages shared
            # with prefix entries. Zero while kv_pages == 0.
            "kv_pages_total": 0,
            "kv_pages_free": 0,
            "kv_page_fragmentation": 0.0,
            "kv_page_cow_copies": 0,
            "flight_enabled": 1 if self._flight is not None else 0,
            # Cold start (coldstart.py): whether the persistent build
            # cache is writable (this package's analog of the compile
            # cache), the PHASE_CODES index of the bring-up (0 idle → 5
            # ready), warmup progress, the manifest's verdict, and the
            # weights streamed by a loader.
            "compile_cache_enabled": 1 if build_cache_dir() else 0,
            "warmup_phase": PHASE_CODES[self._coldstart.current_phase()],
            "warmup_programs_total": 0,
            "warmup_programs_done": 0,
            "warmup_manifest_hits": 0,
            "warmup_manifest_misses": 0,
            "weights_bytes_total": 0,
            "weights_bytes_loaded": 0,
        }
        self._gr_mask_sum = 0.0
        self._gr_mask_steps = 0
        self._init_device_state()
        # A loader streamed its weights before the metrics existed.
        self._sync_coldstart_metrics()

    @torch.no_grad()
    def _resolve_params(self, params, seed: int):
        """The engine's weights under ``EngineConfig.quant``: a loader
        callable is called once here; a pre-quantized tree's mode is
        adopted (a contradicting config raises); ``params=None`` is drawn
        from ``seed``, born quantized when ``quant`` is set; full-precision
        params with ``quant`` set are quantized on their device."""
        qmode = quant.validate_mode(self.cfg.quant)
        if callable(params):
            # A streaming checkpoint loader (runtime/providers.py), under
            # the weights_load phase (warmup.py).
            params = self._load_params_overlapped(params)
        if params is not None and quant.params_quantized(params):
            # Its mode is authoritative: a silent w8/w8d mismatch would
            # serve the wrong arithmetic.
            detected = quant.detect_mode(params)
            if qmode is None:
                qmode = detected
            elif qmode != detected:
                raise ValueError(
                    f"EngineConfig.quant={qmode!r} but supplied params are "
                    f"{detected!r}-quantized"
                )
        mesh = self._mesh
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if qmode:
                # Born quantized: at flagship sizes the full-precision tree
                # would not fit on the card beside the int8 one.
                return quant.init_params_quantized(self.model_cfg, gen, self.device, qmode,
                                                   dtype=self._dtype, mesh=mesh)
            return llama.init_params(self.model_cfg, gen, self.device, dtype=self._dtype,
                                     mesh=mesh)
        if mesh is not None and llama.params_sharded(params, self.model_cfg, self.cfg.tp):
            return params   # this rank's slice already (a loader with mesh=)
        if qmode and not quant.params_quantized(params):
            # Whole layers first: a row-parallel weight's scales span its K.
            params = quant.quantize_params(params, self.model_cfg, qmode)
        if mesh is not None:
            specs = llama.param_specs(self.model_cfg)
            if qmode:
                specs = quant.quantize_param_specs(specs, self.model_cfg, qmode)
            params = shard_pytree(params, specs, mesh, self.device)
        return params

    def _alloc_kv_state(self):
        """Fresh slot caches (ck, cv) at the engine's layout and
        representation: the allocation half of ``_init_device_state``,
        also the loader overlap's scratch state. Touches no books."""
        if self.cfg.kv_pages > 0:
            return self._alloc_paged_kv()
        return llama.init_kv_cache(self.model_cfg, self.cfg.num_slots, self.cfg.max_seq,
                                   self.device, dtype=self._dtype, kv_quant=self._kv_quant,
                                   tp=self.cfg.tp)

    def _init_device_state(self):
        """(Re)allocate the KV caches (and the page books) and per-slot
        device state."""
        B, dev = self.cfg.num_slots, self.device
        if self._ring_graphs is not None:
            # The old graphs point at the state about to be freed: let
            # their last replay finish, then drop them.
            torch.cuda.synchronize(dev)
            self._ring_graphs = None
        # Free the old caches and tables before allocating.
        self._ck = self._cv = self._pk = self._pv = self._gtable = None
        if self.cfg.kv_pages > 0:
            # One page pool serves the slots and the prefix entries.
            self._init_paged_state()
        else:
            self._ck, self._cv = self._alloc_kv_state()
            if self._prefix_pool is not None:
                # The pool [L, P, R, H, D] in the cache's representation;
                # device entries died with the old one, host-tier entries
                # survive.
                self._pk, self._pv = llama.init_kv_cache(
                    self.model_cfg, self.cfg.prefix_cache_slots,
                    self.cfg.prefix_buckets()[-1], dev, dtype=self._dtype,
                    kv_quant=self._kv_quant, tp=self.cfg.tp,
                )
                self._prefix_pool.on_device_reset()
                self.metrics["prefix_cache_evictions"] = self._prefix_pool.evictions
        self.metrics["kv_quant_device_bytes"] = cache_bytes(self._ck, self._cv, self._pk,
                                                            self._pv)
        # Grammar state: per-slot FSM tables [B, grammar_max_states, V],
        # states and active flags; none of it with grammar off.
        self._gstate = self._gactive = self._gbias_zero = self._gslot_key = None
        if self._gr_on:
            V, Sg = self.model_cfg.vocab_size, self.cfg.grammar_max_states
            table_bytes = B * Sg * V * 4
            if table_bytes > 1 << 30:
                logger.warning(
                    "grammar transition tables need %.1f GiB of device memory "
                    "(num_slots=%d x grammar_max_states=%d x vocab=%d x 4B); size "
                    "grammar_max_states down to the largest schema you serve",
                    table_bytes / (1 << 30), B, Sg, V)
            self._gtable = torch.zeros((B, Sg, V), dtype=torch.int32, device=dev)
            self._gstate = torch.zeros(B, dtype=torch.int32, device=dev)
            self._gactive = torch.zeros(B, dtype=torch.bool, device=dev)
            self._gbias_zero = torch.zeros(V, dtype=torch.float32, device=dev)
            # What each slot's table rows hold, so that placing the same
            # grammar again skips the upload.
            self._gslot_key = [None] * B
        self._tokens = torch.zeros(B, dtype=torch.int32, device=dev)
        self._positions = torch.zeros(B, dtype=torch.int32, device=dev)  # next write row
        self._temp = torch.zeros(B, dtype=torch.float32, device=dev)
        self._top_p = torch.ones(B, dtype=torch.float32, device=dev)
        self._top_k = torch.zeros(B, dtype=torch.int32, device=dev)
        self._active = torch.zeros(B, dtype=torch.bool, device=dev)
        self._budget = torch.zeros(B, dtype=torch.int32, device=dev)
        self._stop_ids = torch.full((B, MAX_DEVICE_STOP_IDS), -1,
                                    dtype=torch.int32, device=dev)
        self._key_data = torch.stack(
            [make_slot_key_data(self._seed + 1 + i, dev) for i in range(B)]
        )
        # The ring's per-slot grammar EOS (-1 = none): only the ring's
        # grammar edition reads it.
        self._geos = None
        if self._gr_on and self.cfg.decode_ring > 0:
            self._geos = torch.full((B,), -1, dtype=torch.int32, device=dev)

    def _ring(self) -> Optional[RingGraphs]:
        """The card's captured ring chunks over the current state (graphs.py),
        every chunk size captured at first need; None with the ring off or
        on the CPU, where the ring chunk runs eagerly. No fallback: a
        failed capture raises."""
        if self.cfg.decode_ring == 0 or self.device.type != "cuda":
            return None
        if self._ring_graphs is not None:
            return self._ring_graphs
        graphs = RingGraphs(
            self._step_fn,
            (self._tokens, self._positions, self._active, self._budget, self._key_data,
             self._gstate),
            dict(params=self.params, ck=self._ck, cv=self._cv, stop_ids=self._stop_ids,
                 temp=self._temp, top_p=self._top_p, top_k=self._top_k,
                 g=(self._gtable, self._gactive) if self._gr_on else (), geos=self._geos),
            self.device)
        for chunk in self._decode_fns:
            graphs.capture(chunk)
        self._ring_graphs = graphs
        return graphs

    def _kernel_edition(self) -> str:
        """The decode-attention edition of this engine's cache."""
        return edition(self._kv_quant is not None, self.cfg.kv_pages > 0)

    def kv_bytes_per_token(self) -> int:
        """Device bytes one cached token costs (k + v over all layers and
        all KV heads, f32 row scales included under kv_quant): the model's
        figure, summed over the ranks under tp, as the JAX engine reports
        it; ``kv_quant_device_bytes`` is this rank's allocation."""
        mc = self.model_cfg
        itemsize = 1 if self._kv_quant else self._dtype.itemsize
        scale_bytes = 4 if self._kv_quant else 0
        return mc.num_layers * mc.num_kv_heads * (mc.head_dim * itemsize + scale_bytes) * 2

    # ------------------------------------------------------------------
    # Submission API
    # ------------------------------------------------------------------

    def submit(self, prompt_tokens: list[int],
               params: SamplingParams = SamplingParams(),
               session_id: Optional[str] = None, grammar=None,
               deadline_s: Optional[float] = None,
               trace_ctx: Optional[str] = None) -> RequestHandle:
        """Queue a generation request. With a session_id the session's KV
        rows persist across requests: the next request prefills only the
        tokens past its longest common prefix with what is cached. A
        prompt longer than the largest prefill bucket prefills in pieces;
        the one hard limit is the cache (max_seq - 2). With a grammar
        (either package's compiled grammar; grammar=True) every sampled
        token is FSM-masked on the device and EOS is admissible only in
        accepting states. With a trace_ctx (a W3C traceparent) and the
        flight recorder on, the request's span joins that trace."""
        if self._fault_plan is not None and self._fault_plan.take_submit_fault():
            raise RuntimeError("injected flaky submit (FaultPlan)")
        rid = f"req-{next(self._req_counter)}"
        handle = RequestHandle(rid)
        request = Request(rid, list(prompt_tokens), params, session_id=session_id,
                          grammar=grammar, trace_ctx=trace_ctx)
        if deadline_s is not None:
            request.deadline_at = self.clock() + deadline_s
        error = self._submit_error(prompt_tokens, params, grammar)
        if error is not None:
            self._push_final(handle, rid, FinishReason.ERROR, error=error)
            return handle
        with self._lock:
            if self._draining:
                shed_why = "engine draining (stop(drain=True))"
            elif 0 < self.cfg.max_queue <= len(self._waiting):
                shed_why = f"queue full (max_queue={self.cfg.max_queue})"
            else:
                self._waiting.append((request, handle))
                self.metrics["requests_submitted"] += 1
                if self._flight is not None:
                    # Inside the admission critical section: the engine
                    # thread cannot claim the request before its submit
                    # event is recorded.
                    self._flight.note_submit(rid, len(prompt_tokens), trace_ctx, self.tracer)
                return handle
            self.metrics["requests_shed"] += 1
        self._push_final(handle, rid, FinishReason.OVERLOADED, error=shed_why)
        return handle

    def supports_grammar(self) -> bool:
        """True when this engine enforces request grammars (the runtime
        attaches one only then)."""
        return self._gr_on

    def _submit_error(self, prompt_tokens: list[int], params: SamplingParams,
                      grammar) -> Optional[str]:
        """Why a request is refused at submit, or None."""
        if grammar is not None:
            error = self._validate_grammar(grammar, params)
            if error is not None:
                return error
            self.metrics["grammar_compile_hits"] = grammar_cache_stats["hits"]
            self.metrics["grammar_compile_misses"] = grammar_cache_stats["misses"]
        if not prompt_tokens:
            return "empty prompt"
        if params.max_tokens < 1:
            return f"max_tokens must be >= 1, got {params.max_tokens}"
        if not self.cfg.usable_buckets():
            return "no usable prefill buckets (all exceed max_seq)"
        if not all(0 <= t < self.model_cfg.vocab_size for t in prompt_tokens):
            # An id past the embedding table would fault the device.
            return f"prompt token ids must lie in [0, {self.model_cfg.vocab_size})"
        if len(prompt_tokens) > self.cfg.max_seq - 2:
            return (f"prompt of {len(prompt_tokens)} tokens exceeds KV "
                    f"capacity (max_seq {self.cfg.max_seq} - 2)")
        return None

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s.active)

    def decode_slots_active(self) -> int:
        """Occupied decode slots (equal to active_slots here)."""
        return self.active_slots()

    def healthy(self) -> bool:
        """The readiness signal: false from a watchdog trip until the
        recovery has run on the device, and once a recovery failed."""
        return self._healthy

"""Engine request/response types (the port's own copy of the parts of
``omnia_tpu/engine/types.py`` that its engine uses, ``SessionExport``
included).

``EngineConfig`` keeps every field of the JAX package's, with the same
defaults, so one set of field values configures both engines. The
engine refuses a combination it cannot run, naming its ROADMAP item
(``decode_ring >= 2`` above degree 1, see ``engine/engine.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from typing import Iterator, Optional

import torch

# Per-slot stop-token ids tracked on the device (padded with -1). Ids
# past this many are checked on the host only.
MAX_DEVICE_STOP_IDS = 8


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.7
    top_p: float = 1.0
    top_k: int = 0
    max_tokens: int = 256
    stop_token_ids: tuple[int, ...] = ()
    seed: Optional[int] = None


class FinishReason(enum.Enum):
    STOP = "stop"          # hit a stop/EOS token
    LENGTH = "length"      # hit max_tokens or context limit
    CANCELLED = "cancelled"
    ERROR = "error"
    DEADLINE = "deadline"
    OVERLOADED = "overloaded"


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    params: SamplingParams
    session_id: Optional[str] = None
    grammar: Optional[object] = None
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    # Absolute deadline in the engine's clock (engine.clock()); None = none.
    deadline_at: Optional[float] = None
    trace_ctx: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One engine output event: a generated token, or end-of-stream."""

    request_id: str
    token_id: Optional[int] = None
    finish_reason: Optional[FinishReason] = None
    # Filled on the final event.
    num_prompt_tokens: int = 0
    num_generated_tokens: int = 0
    error: Optional[str] = None

    @property
    def is_final(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass
class SessionExport:
    """One idle session's portable residency record: what
    ``export_session`` hands a coordinator and ``import_session`` takes.

    ``host_k``/``host_v`` are the host offload rows ``[L, R, Hkv, D]``
    (R = ``restore_rows``, the session's restore bucket) as numpy arrays,
    or a ``QuantKV`` of numpy leaves under ``kv_quant``; a paged engine
    gathers its pages into the same layout. bf16 rows travel as their
    16-bit patterns (``np.uint16``: numpy has no bf16 without
    ``ml_dtypes``). ``kv_quant`` and ``restore_rows`` stamp the payload
    so an incompatible engine refuses it at import."""

    session_id: str
    token_ids: list
    host_k: object
    host_v: object
    kv_quant: Optional[str] = None
    restore_rows: int = 0


class RequestHandle:
    """Consumer side of a submitted request: iterate StreamEvents."""

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        self._queue: "queue.Queue[StreamEvent]" = queue.Queue()
        self._cancelled = threading.Event()
        self.first_token_at: Optional[float] = None

    def _push(self, event: StreamEvent) -> None:
        if event.token_id is not None and self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self._queue.put(event)

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    def events(self, timeout: Optional[float] = None) -> Iterator[StreamEvent]:
        """Blocking iterator over events until the final one."""
        while True:
            event = self._queue.get(timeout=timeout)
            yield event
            if event.is_final:
                return

    def get_event(self, timeout: Optional[float] = None) -> StreamEvent:
        return self._queue.get(timeout=timeout)

    def collect_tokens(self, timeout: Optional[float] = None) -> tuple[list[int], StreamEvent]:
        """Drain the stream; returns (token_ids, final_event)."""
        toks: list[int] = []
        for ev in self.events(timeout=timeout):
            if ev.token_id is not None:
                toks.append(ev.token_id)
            if ev.is_final:
                return toks, ev
        raise AssertionError("stream ended without final event")


def resolve_dtype(name: str) -> torch.dtype:
    """EngineConfig.dtype string → torch dtype."""
    table = {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }
    if name not in table:
        raise ValueError(f"unknown engine dtype {name!r}; have {sorted(table)}")
    return table[name]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine shape/placement configuration: the fields and
    defaults of ``omnia_tpu.engine.types.EngineConfig``, documented
    there. num_slots fixes the decode batch, prefill_buckets the prefill
    lengths, max_seq the KV cache rows per slot; kv_quant="int8" stores
    the KV cache as int8 rows with f32 row scales, and kv_pages > 0
    replaces the slot-contiguous cache by a pool of kv_pages pages of
    kv_page_tokens rows (page 0 reserved) behind per-slot page tables;
    prefix_cache_slots > 0 keeps a pool of prefixes shared across
    sessions (engine/prefix_cache.py), and grammar=True lets a request
    carry a grammar whose FSM masks every sampled token;
    prefill_chunk_tokens > 0 feeds an arriving prompt to the batch in
    pieces fused with decode steps (engine/interleave.py), and
    spec_decode > 0 verifies prompt-lookup proposals for greedy slots
    (engine/spec_decode.py)."""

    num_slots: int = 8
    max_seq: int = 1024
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    dtype: str = "bfloat16"
    dp: int = 1
    tp: int = 1
    sp: int = 1
    long_prefill_threshold: int = 2048
    # Decode steps per dispatch; the tail of a generation may take a
    # smaller variant (chunk_variants).
    decode_chunk: int = 8
    decode_chunk_variants: tuple[int, ...] = ()
    # Decode chunks kept in flight before the oldest one's tokens are read.
    decode_pipeline: int = 2
    max_sessions: int = 64
    spec_decode: int = 0
    spec_decode_max: int = 0
    spec_gate_window: int = 0
    quant: Optional[str] = None
    kv_quant: Optional[str] = None
    kv_pages: int = 0
    kv_page_tokens: int = 64
    prefix_cache_slots: int = 0
    prefix_cache_rows: int = 0
    prefix_cache_publish_threshold: int = 2
    prefix_cache_min_tokens: int = 8
    prefix_cache_host_entries: int = 32
    grammar: bool = False
    # submit() sheds OVERLOADED once this many requests wait; 0 = unbounded.
    max_queue: int = 0
    # A decode chunk's host read longer than this many seconds trips the
    # watchdog: the requests in flight fail and device state reallocates.
    watchdog_s: Optional[float] = None
    grammar_max_states: int = 2560
    prefill_chunk_tokens: int = 0
    # Warmup runs in order on the engine's caches whatever this is (the
    # JAX engine's compile pool has nothing to overlap here); N > 0 runs
    # the param-free tasks on a side thread while a weights loader streams,
    # holding one scratch KV cache meanwhile.
    warmup_threads: int = 0
    # Flight-recorder ring capacity in events; 0 keeps no recorder.
    flight_events: int = 0
    decode_ring: int = 0

    def spec_window(self) -> int:
        """Speculative verify window W: the most proposals any slot may
        submit per verify step (the verify forward is [num_slots, W + 1]).
        0 while speculation is off."""
        if not self.spec_decode:
            return 0
        return max(self.spec_decode, self.spec_decode_max)

    def mixed_prefill_buckets(self) -> tuple[int, ...]:
        """Prefill-piece buckets of the fused prefill + decode steps:
        every usable bucket a budget-sized piece can land in, plus the
        1-token degrade bucket used at the cache end. () while
        interleaving is off."""
        usable = self.usable_buckets()
        if self.prefill_chunk_tokens <= 0 or not usable:
            return ()
        cap = self.bucket_for(min(self.prefill_chunk_tokens, max(usable)))
        return tuple(sorted({b for b in usable if b <= cap} | {1}))

    def chunk_variants(self) -> tuple[int, ...]:
        """Decode-chunk sizes, descending, always containing decode_chunk
        and 1 (the queued-prefill TTFT escape hatch)."""
        sizes = set(self.decode_chunk_variants) | {max(1, self.decode_chunk), 1}
        bad = [k for k in sizes if k < 1 or k > max(1, self.decode_chunk)]
        if bad:
            raise ValueError(
                f"decode_chunk_variants {bad} outside [1, decode_chunk]"
            )
        return tuple(sorted(sizes, reverse=True))

    def num_page_positions(self) -> int:
        """Page-table width: table positions per slot (max_seq / page)."""
        return self.max_seq // max(self.kv_page_tokens, 1)

    def prefix_rows(self) -> int:
        """Row capacity of one shared-prefix pool entry."""
        rows = self.prefix_cache_rows or self.max_seq
        return min(rows, self.max_seq)

    def prefix_buckets(self) -> tuple[int, ...]:
        """Row counts of the shared-prefix pool's transfers (store, seed,
        demote): the restore buckets that fit one entry."""
        buckets = tuple(b for b in self.restore_buckets() if b <= self.prefix_rows())
        return buckets or self.restore_buckets()[:1]

    def prefix_bucket_for(self, n: int) -> int:
        for b in self.prefix_buckets():
            if n <= b:
                return b
        return self.prefix_buckets()[-1]

    def page_run_buckets(self) -> tuple[int, ...]:
        """Page counts of the prefix host tier's page-run transfers:
        powers of two up to the pages of one entry."""
        cap = max(-(-self.prefix_rows() // max(self.kv_page_tokens, 1)), 1)
        out, b = [], 1
        while b < cap:
            out.append(b)
            b *= 2
        out.append(cap)
        return tuple(out)

    def page_bucket_for(self, n: int) -> int:
        for b in self.page_run_buckets():
            if n <= b:
                return b
        return self.page_run_buckets()[-1]

    def usable_buckets(self) -> tuple[int, ...]:
        """Prefill buckets that fit the KV cache (a bucket's chunk is
        written whole, so it must not exceed max_seq)."""
        return tuple(b for b in self.prefill_buckets if b <= self.max_seq)

    def bucket_for(self, n: int) -> int:
        buckets = self.usable_buckets()
        for b in buckets:
            if n <= b:
                return b
        limit = buckets[-1] if buckets else 0
        raise ValueError(
            f"prompt of {n} tokens exceeds largest usable prefill bucket {limit}"
        )

    def restore_buckets(self) -> tuple[int, ...]:
        """Row counts a session's KV rows move in between device and
        host: powers of two from the smallest usable bucket, then max_seq."""
        usable = self.usable_buckets()
        b = min(usable) if usable else 64
        out = []
        while b < self.max_seq:
            out.append(b)
            b *= 2
        out.append(self.max_seq)
        return tuple(out)

    def restore_bucket_for(self, n: int) -> int:
        for b in self.restore_buckets():
            if n <= b:
                return b
        raise ValueError(f"{n} rows exceed max_seq {self.max_seq}")

"""Cold-start instrumentation: submit-to-ready phases and the warmup
manifest (port of ``omnia_tpu/engine/coldstart.py``).

- :class:`ColdStartTracker`: a thread-safe record of the bring-up
  phases (``backend_init`` → ``weights_load`` → ``warmup_compile`` →
  ``warmup_restore`` → ready), with byte-level weight-streaming progress
  and a warmed-programs counter. Phases may overlap (the param-free
  warmup tasks run while the weights stream); the tracker keeps one span
  per phase and reports the most recently begun unfinished phase as
  "current". The engine mirrors every snapshot field into its metrics,
  and the runtime's Health response carries the snapshot while the
  server reports "initializing".

- :class:`WarmupManifest`: a persisted list of every (program family,
  shape) the engine warmed on its first start, keyed by a content hash
  of (model config, engine config, backend). A restarting engine loads
  the manifest for its key and knows, before warming anything, which
  programs its persistent build cache should serve, so the
  ``warmup_manifest_hits`` / ``_misses`` metrics say whether this start
  is a warm restore or a cold one. This package has no XLA compile
  cache: its persistent cache is the kernel build directory
  (``kernels.BUILD_DIR``), and the manifest lives there.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

#: Bring-up phases, in nominal order. ``PHASE_CODES`` maps each to the
#: integer exported through the ``warmup_phase`` metric (dashboards get
#: a monotone gauge; 0 = not started, len-1 = ready).
PHASES = (
    "idle",            # 0: engine object exists, nothing begun
    "backend_init",    # 1: accelerator backend/runtime coming up
    "weights_load",    # 2: checkpoint streaming to device
    "warmup_compile",  # 3: building kernels and running every program shape
    "warmup_restore",  # 4: restoring pristine device state post-warmup
    "ready",           # 5: submit-to-ready complete
)
PHASE_CODES = {name: i for i, name in enumerate(PHASES)}


def _pick_phase(ready: bool, spans: dict) -> str:
    """Current phase from the span table (pure; caller holds the lock):
    the latest begun-and-unfinished phase, else the latest finished one
    (a between-phases probe never reads "idle" mid-bring-up)."""
    if ready:
        return "ready"
    current = "idle"
    for name, span in spans.items():
        if span[1] is None:
            current = name  # latest begun, still running
    if current == "idle" and spans:
        current = list(spans)[-1]
    return current


class ColdStartTracker:
    """Thread-safe bring-up progress: phase spans, weight bytes, and the
    warmed-programs counter.

    Writers are the engine's init/warmup seams (possibly several threads
    when weight streaming overlaps warmup); readers are the metrics
    mirror and the runtime Health handler. Every mutation and snapshot
    runs under one internal lock, held only for O(1) work.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        # phase -> [start_mono, end_mono | None]; insertion order is
        # begin order, which is what "current phase" reads back.
        self._spans: dict[str, list] = {}  # guarded-by: _lock
        self._weights_loaded = 0  # guarded-by: _lock
        self._weights_total = 0  # guarded-by: _lock
        self._programs_total = 0  # guarded-by: _lock
        self._programs_done = 0  # guarded-by: _lock
        self._manifest_hits = 0  # guarded-by: _lock
        self._manifest_misses = 0  # guarded-by: _lock
        self._ready = False  # guarded-by: _lock

    # -- writers ---------------------------------------------------------

    def begin_phase(self, name: str) -> None:
        if name not in PHASE_CODES:
            raise ValueError(f"unknown cold-start phase {name!r}")
        with self._lock:
            self._spans[name] = [self._clock(), None]
            # Re-entering a phase (a second warmup on a live engine)
            # un-readies the tracker so probes read the phase actually
            # running, not a stale "ready".
            self._ready = False

    def end_phase(self, name: str) -> float:
        """Close the phase span; returns its duration in seconds (0.0
        for a phase that was never begun — callers stay unconditional)."""
        with self._lock:
            span = self._spans.get(name)
            if span is None:
                return 0.0
            if span[1] is None:
                span[1] = self._clock()
            return span[1] - span[0]

    def note_weights(self, loaded_bytes: int, total_bytes: int) -> None:
        """Weight-streaming progress (monotone; the checkpoint loader's
        ``progress_cb`` lands here, once per streamed tensor)."""
        with self._lock:
            self._weights_loaded = max(self._weights_loaded, int(loaded_bytes))
            self._weights_total = max(self._weights_total, int(total_bytes))

    def set_programs_total(self, n: int) -> None:
        """Declare THIS warmup's task count; resets the done counter so
        a re-warmup (warmup(sessions=False) then a full warmup()) can
        never report done > total."""
        with self._lock:
            self._programs_total = int(n)
            self._programs_done = 0

    def note_program(self, n: int = 1) -> int:
        """One warmup task run; returns the running count."""
        with self._lock:
            self._programs_done += n
            return self._programs_done

    def note_manifest(self, hits: int, misses: int) -> None:
        with self._lock:
            self._manifest_hits = int(hits)
            self._manifest_misses = int(misses)

    def mark_ready(self) -> None:
        with self._lock:
            self._ready = True

    # -- readers ---------------------------------------------------------

    def current_phase(self) -> str:
        with self._lock:
            return _pick_phase(self._ready, self._spans)

    def phase_seconds(self) -> dict:
        """phase -> wall seconds (running phases measured up to now)."""
        with self._lock:
            now = self._clock()
            return {
                name: round((span[1] if span[1] is not None else now) - span[0], 6)
                for name, span in self._spans.items()
            }

    def snapshot(self) -> dict:
        """One consistent progress view: the shape the Health wire and
        the engine metrics mirror read."""
        with self._lock:
            now = self._clock()
            phase = _pick_phase(self._ready, self._spans)
            return {
                "phase": phase,
                "phase_code": PHASE_CODES[phase],
                "weights_bytes_loaded": self._weights_loaded,
                "weights_bytes_total": self._weights_total,
                "programs_total": self._programs_total,
                "programs_done": self._programs_done,
                "manifest_hits": self._manifest_hits,
                "manifest_misses": self._manifest_misses,
                "phases_s": {
                    name: round(
                        (span[1] if span[1] is not None else now) - span[0], 6
                    )
                    for name, span in self._spans.items()
                },
            }


# ---------------------------------------------------------------------------
# Warmup manifest
# ---------------------------------------------------------------------------


def manifest_dir() -> Optional[str]:
    """Directory warmup manifests persist under: the explicit override
    (``OMNIA_WARMUP_MANIFEST_DIR``), else the persistent build cache
    when it is writable (manifests describe that cache's contents, so
    they live and die with it), else None: manifest bookkeeping then
    runs in memory only (every start is an all-miss cold start)."""
    env = os.environ.get("OMNIA_WARMUP_MANIFEST_DIR")
    if env:
        return env
    return build_cache_dir()


def build_cache_dir() -> Optional[str]:
    """The persistent build cache (``kernels.BUILD_DIR``, where nvcc's
    libraries land) when this process may write there, else None."""
    from omnia_tpu_torch import kernels

    d = kernels.BUILD_DIR
    probe = d if d.exists() else d.parent
    return str(d) if os.access(probe, os.W_OK) else None


class WarmupManifest:
    """Load/store the per-config list of warmed (family, shape) keys.

    One JSON file per manifest key under :func:`manifest_dir`; writes are
    atomic (tmp + rename) and best-effort — a read-only cache dir
    degrades to cold-start accounting, never to a failed warmup."""

    @staticmethod
    def manifest_key(payload: dict) -> str:
        """Content hash of the config payload (model config, bucket set,
        KV knobs...). Canonical-JSON sha256, so two processes with the
        same serving config derive the same key with no coordination."""
        import hashlib

        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    @staticmethod
    def _path(directory: str, key: str) -> str:
        return os.path.join(directory, f"warmup_manifest_{key}.json")

    @classmethod
    def load(cls, directory: Optional[str], key: str) -> Optional[list]:
        """The program-key list persisted for this config key, or None
        (no manifest: first start, different config, or no cache dir)."""
        if not directory:
            return None
        try:
            with open(cls._path(directory, key), encoding="utf-8") as f:
                doc = json.load(f)
            programs = doc.get("programs")
            return list(programs) if isinstance(programs, list) else None
        except (OSError, ValueError):
            return None

    @classmethod
    def store(cls, directory: Optional[str], key: str, programs: list,
              meta: Optional[dict] = None) -> bool:
        """Persist (merging with any existing list — warmup(sessions=
        False) must not erase the sessionful families a previous full
        warmup recorded). Returns False when the dir is unwritable."""
        if not directory:
            return False
        existing = cls.load(directory, key) or []
        merged = sorted(set(existing) | set(programs))
        doc = {
            "key": key,
            "programs": merged,
            "meta": dict(meta or {}),
            "saved_at": time.time(),
        }
        path = cls._path(directory, key)
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            return True
        except OSError:
            logger.warning("warmup manifest not persisted under %s "
                           "(unwritable?) — next start re-discovers the "
                           "program set", directory, exc_info=True)
            return False


def manifest_bookkeeping(
    directory: Optional[str], key: str, program_keys: list,
    tracker: ColdStartTracker, meta: Optional[dict] = None,
) -> tuple[int, int]:
    """The one manifest transaction every engine runs at warmup: load
    the persisted list for this config key, count hits (programs the
    last start already warmed: the persistent cache should serve them)
    and misses (new shapes this start must warm), record both on the
    tracker, and persist the current program set. Returns (hits,
    misses)."""
    listed = WarmupManifest.load(directory, key)
    if listed is None:
        hits, misses = 0, len(program_keys)
    else:
        listed_set = set(listed)
        hits = sum(1 for p in program_keys if p in listed_set)
        misses = len(program_keys) - hits
    tracker.note_manifest(hits, misses)
    WarmupManifest.store(directory, key, program_keys, meta=meta)
    return hits, misses

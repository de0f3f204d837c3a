"""Warmup: every program shape run once before readiness (port of
``omnia_tpu/engine/warmup.py``).

PyTorch compiles nothing per shape, but a request path that meets a shape
for the first time still pays for it: the kernel library's build and
load, cuBLAS's first call at a shape, the caching allocator's first
blocks. ``warmup()`` pays that before the engine reports ready.

- **One task list, run in order.** ``_warmup_tasks`` enumerates every
  (family, shape) as a closure over a :class:`_WarmupState` (the KV
  caches a task writes through). ``warmup()`` runs them on the caller's
  thread against the engine's own caches, whatever
  ``EngineConfig.warmup_threads`` says. The JAX engine's worker pool
  overlaps XLA compiles; here there is nothing per shape to compile, the
  tasks are launches that share one interpreter lock and one stream, and
  a pool would only hold scratch caches and streams of its own.
- **Manifest and progress.** Every warmup runs the manifest transaction
  (:func:`~omnia_tpu_torch.engine.coldstart.manifest_bookkeeping`) and
  mirrors the tracker into the ``warmup_*`` metrics. The port keeps no
  per-shape artifact, so the manifest's hits are bookkeeping kept equal
  to the JAX engine's, not a sign of a warm start.
- **Param-free overlap.** With ``warmup_threads > 0`` and a loader
  callable for the weights, ``_load_params_overlapped`` runs the
  families that take no weights (the kernel build, session offload and
  restore, page copies) on a side thread, against scratch caches, while
  the loader streams: a start whose kernel library is not built yet
  pays max(load, nvcc) for it instead of the sum.

No fallback: a task's exception (a failed kernel build included) is
raised out of ``warmup()``, or out of the construction whose overlap it
ran in. Warmup writes only scratch rows and restores the device state
and the metrics it touched, so it cannot perturb what requests get.

Under tensor parallelism every task's forward holds collectives, so every
rank must run the same task list in the same order. The ranks first
compare a digest of their lists and raise on a mismatch; a rank that
never arrives (or stops between tasks) makes the others' next collective
raise after the process group's timeout (``parallel/distributed.py``)
instead of hanging.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from omnia_tpu_torch import kernels
from omnia_tpu_torch.engine.coldstart import (
    PHASE_CODES,
    WarmupManifest,
    manifest_bookkeeping,
    manifest_dir,
)
from omnia_tpu_torch.engine.graphs import NO_DEADLINE
from omnia_tpu_torch.engine.types import SamplingParams
from omnia_tpu_torch.models.kv_quant import kv_device, kv_host
from omnia_tpu_torch.parallel.collectives import all_gather

logger = logging.getLogger(__name__)

#: Families whose tasks take no model weights: runnable while the
#: checkpoint still streams (the weights/warmup overlap set).
PARAMFREE_FAMILIES = frozenset({"kernels", "session", "pages"})


class _WarmupState:
    """The caches a warmup task writes through: the engine's own, or the
    overlap's scratch ones. Everything else a task reads is shared,
    read-only engine state."""

    __slots__ = ("ck", "cv")

    def __init__(self, ck, cv):
        self.ck, self.cv = ck, cv


class _WarmupMixin:
    """Warmup methods of :class:`InferenceEngine`."""

    # -- task inventory --------------------------------------------------

    def _warmup_tasks(self, families: Optional[frozenset] = None
                      ) -> list[tuple[str, str, Callable]]:
        """The (family, shape-key, closure) inventory, in the order the
        serial warmup runs it. Closures read engine state at call time,
        so the param-free subset runs before the weights exist."""
        cfg, dev = self.cfg, self.device
        sp = SamplingParams(temperature=0.0)
        tasks: list[tuple[str, str, Callable]] = []

        def add(family: str, key: str, fn: Callable) -> None:
            if families is None or family in families:
                tasks.append((family, key, fn))

        def piece(b: int) -> tuple:
            """A b-token piece at rows [0, b) of slot 0."""
            toks = torch.zeros((1, b), dtype=torch.int32, device=dev)
            pos = torch.arange(b, dtype=torch.int32, device=dev)[None]
            return toks, pos, 0, self._scalar(0, torch.int32)

        def first(b: int) -> tuple:
            """The first-token sampler's operands after a b-token piece."""
            return (b - 1, *self._sampler_args(0, sp), *self._grammar_args(None, sp))

        def no_deadline() -> np.ndarray:
            return np.full((cfg.num_slots,), NO_DEADLINE, np.int32)

        def gargs() -> tuple:
            return (self._gstate, self._gtable, self._gactive) if self._gr_on else ()

        def decode_args(st) -> tuple:
            return (self.params, st.ck, st.cv, self._tokens, self._positions, self._active,
                    self._budget, self._stop_ids, self._key_data, self._temp, self._top_p,
                    self._top_k)

        if dev.type == "cuda":
            name = self._kernel_edition()
            add("kernels", name, lambda st: kernels.load(name))

        def prefill_task(b):
            def run(st):
                toks, pos, _, _ = piece(b)
                self._prefill_insert_fn(self.params, st.ck, st.cv, toks, pos, 0, *first(b))
            return run

        for b in cfg.usable_buckets():
            add("prefill", f"bucket{b}", prefill_task(b))

        def extend_task(b):
            def run(st):
                self._extend_fn(self.params, st.ck, st.cv, *piece(b), *first(b))
            return run

        for b in sorted(set(cfg.usable_buckets()) | {1}):
            add("extend", f"piece{b}", extend_task(b))

        def session_task(rows):
            def run(st):
                k, v = self._offload_fn(st.ck, st.cv, 0, rows)
                self._restore_fn(st.ck, st.cv, kv_device(kv_host(k), dev),
                                 kv_device(kv_host(v), dev), 0)
            return run

        for rows in cfg.restore_buckets():
            add("session", f"rows{rows}", session_task(rows))

        def decode_task(chunk):
            def run(st):
                graphs = self._ring()
                if graphs is not None:
                    # The card's ring: the first decode task captures every
                    # chunk size on the engine's own state (after the
                    # kernel task built the kernel); each replays its own.
                    graphs.replay(chunk, no_deadline())
                    return
                ring_args = ()
                if cfg.decode_ring > 0:
                    # The ring edition: the per-slot grammar EOS rides
                    # between gactive and the deadline-step budget, as on
                    # the request path.
                    ring_args = (((self._geos,) if self._gr_on else ())
                                 + (torch.from_numpy(no_deadline()).to(dev),))
                self._decode_fns[chunk](*decode_args(st), *gargs(), *ring_args)
            return run

        for chunk in self._decode_fns:
            add("decode", f"chunk{chunk}", decode_task(chunk))

        def verify_operands() -> tuple:
            B, W = cfg.num_slots, cfg.spec_window()
            zeros = torch.zeros((B, W + 1), dtype=torch.int32, device=dev)
            pos = torch.arange(W + 1, dtype=torch.int32, device=dev).expand(B, W + 1)
            return (zeros, pos.contiguous(), zeros[:, 0].contiguous(),
                    torch.zeros(B, dtype=torch.bool, device=dev))

        if self._verify_fn is not None:
            def verify_task(st):
                verify = verify_operands()
                self._verify_fn(self.params, st.ck, st.cv, *verify[:3], *gargs())
                self._verify_decode_fn(*decode_args(st), *verify, *gargs())

            add("spec", "verify", verify_task)

        def mixed_task(b):
            def run(st):
                decode, p, g = decode_args(st), piece(b), gargs()
                self._mixed_fns[b](*decode, *p, *g)
                self._mixed_sample_fns[b](*decode, *p, *first(b), *g)
                if self._verify_fn is not None:
                    verify = verify_operands()
                    self._mixed_spec_fns[b](*decode, *p, *verify, *g)
                    self._mixed_spec_sample_fns[b](*decode, *p, *verify, *first(b), *g)
            return run

        for b in cfg.mixed_prefill_buckets():
            add("mixed", f"bucket{b}", mixed_task(b))

        if cfg.kv_pages > 0:
            # The copy-on-write page copy, trash page onto itself.
            add("pages", "copy", lambda st: self._page_copy_fn(st.ck, st.cv, 0, 0))
        return tasks

    def _agree_on_tasks(self, program_keys: list) -> None:
        """Under tp: every rank's warmup task list must be this one, in
        this order (their collectives pair up call by call). Raises on
        every rank when one differs."""
        if self._tp is None:
            return
        digest = hashlib.sha256("\n".join(program_keys).encode()).digest()
        mine = torch.tensor([int.from_bytes(digest[:7], "big"), len(program_keys)],
                            dtype=torch.int64, device=self.device)
        every = all_gather(mine[None], self._tp, dim=0).tolist()
        differ = [r for r, v in enumerate(every) if v != every[0]]
        if differ:
            raise RuntimeError(
                f"warmup task lists differ across tp ranks (rank 0 vs ranks {differ}: "
                f"{[every[0]] + [every[r] for r in differ]} as [digest, count]); "
                "every rank must build the same EngineConfig")

    def _run_warmup_serial(self, tasks) -> None:
        st = _WarmupState(self._ck, self._cv)
        for _family, _key, fn in tasks:
            fn(st)
            self.metrics["warmup_programs_done"] = self._coldstart.note_program()

    # -- manifest --------------------------------------------------------

    def _warmup_manifest_key(self) -> str:
        """Content key of what determines the program set and its shapes:
        the model config, the engine config less its host-side knobs
        (which change no program, so a restart that tunes only them reads
        the same manifest), and the device type."""
        ecfg = dataclasses.asdict(self.cfg)
        for host_only in ("warmup_threads", "flight_events", "max_queue", "watchdog_s",
                          "decode_pipeline", "spec_gate_window"):
            ecfg.pop(host_only, None)
        return WarmupManifest.manifest_key({
            "model": dataclasses.asdict(self.model_cfg),
            "engine": ecfg,
            "backend": self.device.type,
        })

    # -- overlap with weight streaming ----------------------------------

    def _warmup_paramfree(self) -> None:
        """The param-free families on a scratch state: safe before the
        weights exist, which is when it runs."""
        tasks = self._warmup_tasks(families=PARAMFREE_FAMILIES)
        if not tasks:
            return
        st = _WarmupState(*self._alloc_kv_state())
        for _family, _key, fn in tasks:
            fn(st)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_params_overlapped(self, loader: Callable):
        """Call the weights loader under the ``weights_load`` phase, with
        byte progress when it takes ``progress_cb``. With
        ``warmup_threads > 0`` the param-free warmup runs on a side thread
        meanwhile, and its failure is raised here once the loader is
        done; at 0 no thread starts."""
        cs = self._coldstart
        cs.begin_phase("weights_load")
        side, failure = None, []
        if self.cfg.warmup_threads > 0:
            def overlap():
                try:
                    self._warmup_paramfree()
                except Exception as exc:  # noqa: BLE001 - raised on the caller's thread
                    failure.append(exc)

            side = threading.Thread(target=overlap, name="omnia-warmup-overlap", daemon=True)
            side.start()
        try:
            kwargs = {}
            try:
                if "progress_cb" in inspect.signature(loader).parameters:
                    kwargs["progress_cb"] = cs.note_weights
            except (TypeError, ValueError):
                pass  # a callable without a signature: no progress
            params = loader(**kwargs)
        finally:
            if side is not None:
                side.join()
        if failure:
            raise failure[0]
        seconds = cs.end_phase("weights_load")
        if self._flight is not None:
            self._flight.note_init_phase("weights_load", {
                "seconds": seconds, "bytes": cs.snapshot()["weights_bytes_loaded"],
            })
        return params

    # -- orchestrator ----------------------------------------------------

    def warmup(self):
        """Build the kernel and run every program once at every shape a
        request can give it: each prefill bucket, an extend piece per
        bucket and of one token, an offload and a restore per restore
        bucket, each decode chunk size, the verify window and each mixed
        step, and (paged) the page copy. Then restore the device state
        and the metrics warmup touched. Progress reads on the cold-start
        tracker and the ``warmup_*`` metrics meanwhile."""
        t0 = time.monotonic()
        cs = self._coldstart
        metrics_before = dict(self.metrics)
        tasks = self._warmup_tasks()
        cs.set_programs_total(len(tasks))
        cs.begin_phase("warmup_compile")
        self.metrics["warmup_phase"] = PHASE_CODES["warmup_compile"]
        self.metrics["warmup_programs_total"] = len(tasks)
        self.metrics["warmup_programs_done"] = 0

        program_keys = [f"{family}:{key}" for family, key, _fn in tasks]
        self._agree_on_tasks(program_keys)
        hits, misses = manifest_bookkeeping(
            manifest_dir(), self._warmup_manifest_key(), program_keys, cs,
            meta={"model": self.model_cfg.name, "backend": self.device.type},
        )
        self.metrics["warmup_manifest_hits"] = hits
        self.metrics["warmup_manifest_misses"] = misses

        threads = self.cfg.warmup_threads
        self._run_warmup_serial(tasks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        compile_s = cs.end_phase("warmup_compile")
        if self._flight is not None:
            self._flight.note_init_phase("warmup_compile", {
                "seconds": compile_s, "programs": len(tasks), "threads": threads,
                "manifest_hits": hits, "manifest_misses": misses,
            })

        cs.begin_phase("warmup_restore")
        self.metrics["warmup_phase"] = PHASE_CODES["warmup_restore"]
        self._init_device_state()
        # The ring's graphs pointed at the state just freed: capture them
        # again on the new one, so that no request pays for it.
        self._ring()
        self.metrics.update(metrics_before)
        restore_s = cs.end_phase("warmup_restore")
        cs.mark_ready()
        self._sync_coldstart_metrics()
        if self._flight is not None:
            self._flight.note_init_phase("warmup_restore", {"seconds": restore_s})
        logger.info("engine warmup done in %.1fs (%d programs, threads=%d, manifest %d hit / "
                    "%d miss)", time.monotonic() - t0, len(tasks), threads, hits, misses)

    def _sync_coldstart_metrics(self) -> None:
        """Mirror the tracker into the warmup and weights metrics."""
        snap = self._coldstart.snapshot()
        self.metrics["warmup_phase"] = snap["phase_code"]
        self.metrics["warmup_programs_total"] = snap["programs_total"]
        self.metrics["warmup_programs_done"] = snap["programs_done"]
        self.metrics["warmup_manifest_hits"] = snap["manifest_hits"]
        self.metrics["warmup_manifest_misses"] = snap["manifest_misses"]
        self.metrics["weights_bytes_total"] = snap["weights_bytes_total"]
        self.metrics["weights_bytes_loaded"] = snap["weights_bytes_loaded"]

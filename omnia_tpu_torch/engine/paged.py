"""Paged-KV wiring for the serving engine (port of
``omnia_tpu/engine/paged.py`` without the prefix cache's page runs).

The device side is one page pool plus one per-slot page table
(``PagedKV``, models/paged_kv.py), shared by the k and v caches; this
mixin owns the host side: the single free list (engine/kv_pages.py
``PageAllocator``) that serves the active slots, and the occupancy
gauges (``kv_pages_total/free``, ``kv_page_fragmentation``,
``kv_page_cow_copies``). Every method is a no-op while ``kv_pages == 0``
(``self._pages is None``).

Write protocol: before any program that writes rows [from, through) of
a slot is enqueued, the engine calls ``_prepare_slot_write``: missing
pages are allocated and the slot's table row is rewritten on the device.
Table positions past a slot's pages point at the reserved TRASH page, so
an inactive slot's per-step write of its frozen row never lands in
another slot's rows.

Table rows are written by an asynchronous copy on the current stream,
never read back on the host. A chunk already enqueued reads and writes
through the table as it stood when it was enqueued; every later update
lands after it in stream order. That is what makes it safe to hand a
finished slot's pages to another slot while chunks that still wrote the
finished slot's frozen row are in flight.
"""

from __future__ import annotations

import logging

import torch

from omnia_tpu_torch.engine.kv_pages import PageAllocator, PoolExhausted
from omnia_tpu_torch.engine.types import FinishReason
from omnia_tpu_torch.models import llama
from omnia_tpu_torch.models.kv_quant import is_quant_kv
from omnia_tpu_torch.models.paged_kv import PagedKV

logger = logging.getLogger(__name__)


def validate_paged_config(cfg) -> None:
    """Construction-time validation of the kv_pages knobs (the JAX
    package's checks and messages; the mesh check waits for dp)."""
    if cfg.kv_pages <= 0:
        return
    if cfg.kv_pages < 2:
        raise ValueError(
            f"kv_pages={cfg.kv_pages} must be >= 2: page 0 is the "
            f"reserved trash page, so 1 leaves zero usable pages"
        )
    if cfg.kv_page_tokens < 1 or cfg.max_seq % cfg.kv_page_tokens != 0:
        divisors = [d for d in (16, 32, 64, 128, 256)
                    if d <= cfg.max_seq and cfg.max_seq % d == 0]
        raise ValueError(
            f"kv_page_tokens={cfg.kv_page_tokens} must divide "
            f"max_seq={cfg.max_seq} (the page table is static-shape "
            f"[num_slots, max_seq/kv_page_tokens]); valid sizes include "
            f"{divisors or [cfg.max_seq]}"
        )


class _PagedKVMixin:
    """Paged-pool methods of :class:`InferenceEngine`."""

    _pages = None  # PageAllocator when kv_pages > 0, else None

    # -- device state ----------------------------------------------------

    def _alloc_paged_kv(self):
        """Fresh (ck, cv) PagedKV pair: pools and one all-trash table."""
        cfg = self.cfg
        pool_k, pool_v = llama.init_kv_cache(
            self.model_cfg, cfg.kv_pages, cfg.kv_page_tokens, self.device,
            dtype=self._dtype, kv_quant=self._kv_quant,
        )
        table = torch.zeros((cfg.num_slots, cfg.num_page_positions()),
                            dtype=torch.int32, device=self.device)
        return PagedKV(pool_k, table), PagedKV(pool_v, table)

    def _init_paged_state(self) -> None:
        """(Re)allocate the page pool, the table and the allocator books
        (crash recovery calls it too)."""
        cfg = self.cfg
        self._ck, self._cv = self._alloc_paged_kv()
        self._pages = PageAllocator(cfg.kv_pages, cfg.kv_page_tokens, cfg.num_slots)
        self._update_page_metrics()

    def _sync_table_row(self, slot_idx: int) -> None:
        """Write one slot's whole TRASH-padded table row to the device,
        stream-ordered and without waiting (a pinned staging row)."""
        row = torch.tensor(
            self._pages.table_row(slot_idx, self.cfg.num_page_positions()),
            dtype=torch.int32,
        )
        table = self._ck.table
        if table.is_cuda:
            row = row.pin_memory()
        table[slot_idx].copy_(row, non_blocking=table.is_cuda)

    def _update_page_metrics(self) -> None:
        a = self._pages
        self.metrics["kv_pages_total"] = a.total
        self.metrics["kv_pages_free"] = a.free_count
        self.metrics["kv_page_fragmentation"] = a.fragmentation()
        self.metrics["kv_page_cow_copies"] = a.cow_copies

    # -- the write protocol ----------------------------------------------

    def _prepare_slot_write(self, slot_idx: int, from_row: int,
                            through_row: int) -> None:
        """Make rows [from_row, through_row) of a slot writable before the
        write is enqueued: fresh pages where the table points at trash,
        then the table row rewritten. No-op while kv_pages == 0."""
        if self._pages is None:
            return
        through_row = min(through_row, self.cfg.max_seq)
        if through_row <= from_row:
            return
        need = self._pages.writes_needed(slot_idx, from_row, through_row)
        if need > self._pages.free_count and not self._reclaim_pages(
                need, protect_slot=slot_idx):
            raise PoolExhausted(
                f"kv page pool exhausted writing rows [{from_row}, "
                f"{through_row}) of slot {slot_idx}: need {need} pages, "
                f"{self._pages.free_count} free of {self._pages.total} "
                f"(size kv_pages up, or lower concurrency)"
            )
        # No page is shared without a prefix cache, so no action copies.
        if self._pages.prepare_write(slot_idx, from_row, through_row):
            self._sync_table_row(slot_idx)
            self._update_page_metrics()

    def _prealloc_decode_pages(self, steps: int) -> None:
        """Extend every active slot's pages past its dispatched-write
        frontier before a decode chunk of ``steps`` tokens: decode writes
        must never land through a trash entry. A slot that cannot get its
        pages finishes early with LENGTH; the others go on."""
        if self._pages is None:
            return
        s_max = self.cfg.max_seq
        for i, s in enumerate(self._slots):
            if s.active:
                cov = self._pages.covered[i]
                try:
                    self._prepare_slot_write(i, cov, min(cov + steps, s_max))
                except PoolExhausted:
                    logger.warning(
                        "kv page pool exhausted mid-decode: finishing slot %d "
                        "early with LENGTH at %d generated tokens (%d/%d pages "
                        "free) — size kv_pages up for this concurrency",
                        i, s.generated, self._pages.free_count, self._pages.total,
                    )
                    self._finish_slot(i, FinishReason.LENGTH)

    def _trim_slot_pages(self, slot_idx: int, keep_rows: int) -> None:
        """Return every page past ``keep_rows`` to the free list and point
        the vacated table positions back at trash."""
        if self._pages is None:
            return
        if self._pages.release_from(slot_idx, keep_rows):
            self._sync_table_row(slot_idx)
            self._update_page_metrics()

    def _free_slot_pages(self, slot_idx: int) -> None:
        self._trim_slot_pages(slot_idx, 0)

    def _prepare_slot_restore(self, slot_idx: int, host_k) -> None:
        """Session restore: fresh pages covering the host rows and the
        table row synced before the restore scatters through it."""
        if self._pages is None:
            return
        rows = (host_k.q if is_quant_kv(host_k) else host_k).shape[1]
        self._free_slot_pages(slot_idx)
        self._prepare_slot_write(slot_idx, 0, int(rows))

    def _reclaim_pages(self, need: int, protect_slot: int = -1) -> bool:
        """Offload least-recently-used idle sessions (never the one on
        ``protect_slot``) until ``need`` pages are free. False when no
        offload frees a page any more: every page is held by live work."""
        while self._pages.free_count < need:
            before = self._pages.free_count
            idle = [
                (sess.last_used, sid)
                for sid, sess in self._sessions.items()
                if sess.slot is not None and sess.slot != protect_slot
                and not self._slots[sess.slot].active
            ]
            if idle:
                self._offload_session(self._sessions[min(idle)[1]])
            if self._pages.free_count <= before:
                return False
        return True

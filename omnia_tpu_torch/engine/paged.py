"""Paged-KV wiring for the serving engine (port of
``omnia_tpu/engine/paged.py``).

The device side is one page pool plus one per-slot page table
(``PagedKV``, models/paged_kv.py), shared by the k and v caches; this
mixin owns the host side: the single free list (engine/kv_pages.py
``PageAllocator``) that serves the active slots and the shared-prefix
pool's entries (refcounted page runs: publish and seed rewrite tables,
a write into a shared page copies it first), and the occupancy gauges
(``kv_pages_total/free``, ``kv_page_fragmentation``,
``kv_page_cow_copies``). Every method is a no-op while ``kv_pages == 0``
(``self._pages is None``).

Write protocol: before any program that writes rows [from, through) of
a slot is enqueued, the engine calls ``_prepare_slot_write``: a shared
page in the range is swapped for a fresh one (copied when it holds rows
below ``from``), missing pages are allocated, and the slot's table row
is rewritten on the device. Table positions past a slot's pages point
at the reserved TRASH page, so an inactive slot's per-step write of its
frozen row never lands in another slot's rows. The decode kernels only
read pages, so two slots may read one shared page.

Table rows are written by an asynchronous copy on the current stream,
never read back on the host. A chunk already enqueued reads and writes
through the table as it stood when it was enqueued; every later update
lands after it in stream order. That is what makes it safe to hand a
finished slot's pages to another slot while chunks that still wrote the
finished slot's frozen row are in flight. A copy-on-write page copy is
enqueued before the table row that points at the copy, and both before
the write, all on the one stream.
"""

from __future__ import annotations

import logging

import torch

from omnia_tpu_torch.engine.kv_pages import TRASH, PageAllocator, PoolExhausted
from omnia_tpu_torch.engine.types import FinishReason
from omnia_tpu_torch.models import llama
from omnia_tpu_torch.models.kv_quant import is_quant_kv, kv_device, kv_host
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
            dtype=self._dtype, kv_quant=self._kv_quant, tp=cfg.tp,
        )
        table = torch.zeros((cfg.num_slots, cfg.num_page_positions()),
                            dtype=torch.int32, device=self.device)
        return PagedKV(pool_k, table), PagedKV(pool_v, table)

    def _init_paged_state(self) -> None:
        """(Re)allocate the page pool, the table and the allocator books
        (crash recovery calls it too)."""
        cfg = self.cfg
        self._ck, self._cv = self._alloc_paged_kv()
        self._pk = self._pv = None  # the prefix pool shares this pool
        self._pages = PageAllocator(cfg.kv_pages, cfg.kv_page_tokens, cfg.num_slots)
        if self._prefix_pool is not None:
            # Device page runs died with the pool; host-tier entries
            # survive.
            for e in list(self._prefix_pool.entries()):
                if e.pages is not None:
                    e.pages = None
                    self._prefix_pool.evictions += 1
                    if e.host_k is None:
                        self._prefix_pool.drop_entry(e)
            self._prefix_pool.page_release = self._pages.release_pages
            self.metrics["prefix_cache_evictions"] = self._prefix_pool.evictions
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
        acts = self._pages.prepare_write(slot_idx, from_row, through_row)
        for _pos, new_page, copy_src in acts:
            if copy_src is not None:
                self._page_copy_fn(self._ck, self._cv, copy_src, new_page)
        if acts:
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
        """Free pages until ``need`` are: demote least-recently-used
        unpinned prefix entries to the host tier, then offload idle
        sessions (never the one on ``protect_slot``). A demotion whose
        pages a live slot still shares frees nothing now, so the loop
        falls through to an offload. False when neither frees a page:
        every page is held by live work."""
        while self._pages.free_count < need:
            before = self._pages.free_count
            if self._prefix_pool is not None:
                cands = [e for e in self._prefix_pool.entries()
                         if e.pages is not None and e.refs == 0]
                if cands:
                    # Entries whose pages actually free first, LRU within.
                    def key(e):
                        frees = all(self._pages.refs.get(p, 0) == 1 for p in e.pages)
                        return (not frees, e.last_used)

                    self._paged_demote_entry(min(cands, key=key))
            if self._pages.free_count > before:
                continue
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

    # -- the prefix pool over page runs ------------------------------------

    def _paged_adopt_entry(self, entry, slot_idx: int, matched: int) -> bool:
        """Seed a slot from a prefix entry: point its leading table
        positions at the entry's pages (refcounted, no copy). A partly
        matched last page is adopted too; the suffix's first write into
        it copies it. A host-tier entry is first scattered into fresh
        pages, which slot and entry then share."""
        ps = self.cfg.kv_page_tokens
        npg = -(-matched // ps)
        # The slot's stale pages free first: they may cover the promote.
        self._free_slot_pages(slot_idx)
        if entry.pages is None and entry.host_k is not None:
            npg_e = -(-len(entry.tokens) // ps)
            if not self._reclaim_pages(npg_e, protect_slot=slot_idx):
                return False
            pages = self._pages.alloc_pages(npg_e)
            bucket = self.cfg.page_bucket_for(npg_e)
            idx = torch.tensor(pages + [TRASH] * (bucket - npg_e), dtype=torch.int32,
                               device=self.device)
            self._scatter_pages_fn(self._ck, self._cv, idx,
                                   kv_device(entry.host_k, self.device),
                                   kv_device(entry.host_v, self.device))
            entry.pages = pages  # the entry owns these references
            entry.host_k = entry.host_v = None
            self.metrics["prefix_cache_host_hits"] += 1
        if entry.pages is None:
            # A stale radix path after a device reset: rebuild on miss.
            self._prefix_pool.drop_entry(entry)
            return False
        self._pages.adopt(slot_idx, entry.pages[:npg], matched)
        self._sync_table_row(slot_idx)
        self._update_page_metrics()
        return True

    def _paged_publish(self, slot_idx: int, tokens: tuple, registered: bool) -> None:
        """Publish a prefix from a freshly prefilled slot: a new entry
        shares the slot's leading pages (refcount only), which then
        outlive the slot."""
        npg = -(-len(tokens) // self.cfg.kv_page_tokens)
        pages = self._pages.share(slot_idx, npg)
        entry = self._prefix_pool.insert(tuple(tokens), self.cfg.page_bucket_for(npg),
                                         None, registered)
        entry.pages = pages
        self.metrics["prefix_cache_insertions"] += 1
        self._update_page_metrics()

    def _paged_demote_entry(self, entry) -> None:
        """LRU demotion to the host tier: the entry's page run
        (TRASH-padded to its bucket) copied to host RAM verbatim, its
        device pages released."""
        npg = -(-len(entry.tokens) // self.cfg.kv_page_tokens)
        bucket = self.cfg.page_bucket_for(npg)
        idx = torch.tensor(entry.pages + [TRASH] * (bucket - npg), dtype=torch.int32,
                           device=self.device)
        k, v = self._gather_pages_fn(self._ck, self._cv, idx)
        host_k, host_v = kv_host(k), kv_host(v)
        self._pages.release_pages(entry.pages)
        entry.pages = None
        self._prefix_pool.evictions += 1
        self._prefix_pool.demoted_to_host(entry, host_k, host_v)
        self.metrics["prefix_cache_evictions"] = self._prefix_pool.evictions
        self._update_page_metrics()

"""Host-side page-table books for the paged KV cache (the port's own copy
of ``omnia_tpu/engine/kv_pages.py``, which is plain Python).

The device side is one fixed pool ``[L, P, PAGE_S, Hkv, D]`` plus a
per-slot page table ``[B, max_seq / PAGE_S]`` (models/paged_kv.py); this
module is the single free list behind it: which pool page backs which
table position, page refcounts for copy-on-write sharing, and the
occupancy/fragmentation gauges the engine exports. Every decision here
is a deterministic function of the call sequence, so the port and the
JAX package hand out the same pages for the same calls.

Conventions:

- Page ``TRASH`` (0) is reserved and never allocated: every table
  position not backed by an owned page points at it, so the decode
  step's frozen-slot garbage writes (an inactive slot re-writes one row
  per step — the static-shape contract) land in a page nobody reads.
- ``refs[pid]`` counts table references (slots) plus prefix-entry
  holds. A page with refs > 1 is shared and therefore read-only for
  every holder; ``prepare_write`` swaps it for an exclusive page before
  any write dispatch (copy-on-write when the page holds rows below the
  write start that must survive).
- ``covered[slot]`` is the dispatched-write high-water mark in rows —
  the baseline the decode pre-allocation extends from.
- Under data parallelism (``shards`` > 1, the engine's dp) the page ids
  split into one block of ``num_pages // shards`` per dp shard, each
  with its own trash page (its first) and its own free list, and a slot
  gets pages only from its own shard's block (slot ``i`` belongs to shard
  ``i // (num_slots // shards)``). Page ids stay global in the books; a
  shard's device pool holds its block, at ``pid - base(slot)``. With one
  shard this is the JAX package's allocator, decision for decision.
"""

from __future__ import annotations

TRASH = 0


class PoolExhausted(RuntimeError):
    """The page free list ran dry and reclaim found nothing to evict."""


class PageAllocator:
    """One free list over the device page pool. Engine-thread-owned
    (same discipline as the session registry): no locking here."""

    def __init__(self, num_pages: int, page_tokens: int, num_slots: int, shards: int = 1):
        if num_pages < 2:
            raise ValueError(
                f"kv_pages={num_pages} must be >= 2 (page 0 is the reserved "
                f"trash page, so fewer leaves zero usable pages)"
            )
        if page_tokens < 1:
            raise ValueError(f"kv_page_tokens={page_tokens} must be >= 1")
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.shards = shards
        self.shard_pages = num_pages // shards
        self._shard_slots = num_slots // shards
        # LIFO free lists, one per shard, each seeded so the first
        # allocations hand out the shard's pages base + 1, base + 2, … —
        # deterministic across replicas replaying one event stream
        # (multi-host lockstep).
        self._frees = [list(range((s + 1) * self.shard_pages - 1, s * self.shard_pages, -1))
                       for s in range(shards)]
        self.refs: dict[int, int] = {}
        self.slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.covered = [0] * num_slots
        self.cow_copies = 0

    # -- gauges ---------------------------------------------------------

    @property
    def total(self) -> int:
        """Usable pages (the reserved trash pages excluded)."""
        return self.num_pages - self.shards

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._frees)

    @property
    def _free(self) -> list[int]:
        """Every free page, shard by shard."""
        return [pid for free in self._frees for pid in free]

    def shard_of(self, slot: int) -> int:
        return slot // self._shard_slots

    def base(self, slot: int) -> int:
        """The first page id of the slot's shard: its trash page."""
        return self.shard_of(slot) * self.shard_pages

    def page_shard(self, pid: int) -> int:
        return pid // self.shard_pages

    def free_for(self, slot: int) -> int:
        """Free pages the slot can take: its shard's."""
        return len(self._frees[self.shard_of(slot)])

    def fragmentation(self) -> float:
        """Internal slack of slot-referenced pages: 1 - (covered rows /
        page capacity those rows occupy). 0.0 with nothing allocated —
        fixed-size pages have no external fragmentation, so this is THE
        fragmentation number (the quantity the old bucketed allocators
        wasted at whole-bucket granularity)."""
        capacity = self.page_tokens * sum(len(p) for p in self.slot_pages)
        if capacity <= 0:
            return 0.0
        used = sum(min(c, capacity) for c in self.covered)
        return round(max(0.0, 1.0 - used / capacity), 6)

    # -- allocation core ------------------------------------------------

    def _alloc(self, shard: int = 0) -> int:
        free = self._frees[shard]
        if not free:
            raise PoolExhausted(
                f"kv page pool exhausted: all {self.total} pages of "
                f"{self.page_tokens} tokens are referenced"
            )
        pid = free.pop()
        self.refs[pid] = 1
        return pid

    def _decref(self, pid: int) -> None:
        r = self.refs.get(pid, 0)
        if r <= 1:
            self.refs.pop(pid, None)
            self._frees[self.page_shard(pid)].append(pid)
        else:
            self.refs[pid] = r - 1

    def alloc_pages(self, n: int, shard: int = 0) -> list[int]:
        """n fresh exclusive pages of a shard (refs=1 each, owned by the
        caller)."""
        return [self._alloc(shard) for _ in range(n)]

    def release_pages(self, pages: list[int]) -> None:
        """Drop one reference from each page (prefix-entry drop/demote)."""
        for pid in pages:
            self._decref(pid)

    def incref_pages(self, pages: list[int]) -> None:
        for pid in pages:
            self.refs[pid] += 1

    # -- slot writes ----------------------------------------------------

    def writes_needed(self, slot: int, from_row: int, through_row: int) -> int:
        """Fresh pages ``prepare_write`` would allocate — the reclaim
        budget check (reclaim must run BEFORE allocation starts so a
        mid-prepare exhaustion never leaves a half-updated table)."""
        if through_row <= from_row:
            return 0
        ps = self.page_tokens
        pages = self.slot_pages[slot]
        n = 0
        for pos in range(from_row // ps, (through_row - 1) // ps + 1):
            if pos >= len(pages) or self.refs.get(pages[pos], 0) > 1:
                n += 1
        return n

    def prepare_write(
        self, slot: int, from_row: int, through_row: int
    ) -> list[tuple[int, int, int | None]]:
        """Make every page covering rows [from_row, through_row)
        exclusively writable by ``slot``; returns
        ``[(table_pos, new_page, copy_src_page | None)]`` actions the
        engine turns into page-copy dispatches + a table-row update.

        A shared page (refs > 1) is swapped for a fresh one; it is
        COPIED only when it holds rows below ``from_row`` (content that
        must survive the swap) — the copy-on-write seam. Missing table
        positions get fresh pages with no copy."""
        actions: list[tuple[int, int, int | None]] = []
        if through_row <= from_row:
            return actions
        ps = self.page_tokens
        pages = self.slot_pages[slot]
        shard = self.shard_of(slot)
        for pos in range(from_row // ps, (through_row - 1) // ps + 1):
            if pos < len(pages) and self.refs.get(pages[pos], 0) == 1:
                continue  # already exclusive
            new = self._alloc(shard)
            copy_src = None
            if pos < len(pages):
                old = pages[pos]
                if pos * ps < from_row:
                    copy_src = old  # rows below the write start survive
                    self.cow_copies += 1
                self._decref(old)
                pages[pos] = new
            else:
                while len(pages) < pos:  # defensive: gaps never occur
                    pages.append(self._alloc(shard))
                pages.append(new)
            actions.append((pos, new, copy_src))
        self.covered[slot] = max(self.covered[slot], through_row)
        return actions

    def release_from(self, slot: int, keep_rows: int) -> list[int]:
        """Free every page past the one covering row ``keep_rows - 1``
        (all of them for keep_rows=0); returns the vacated table
        positions (the engine points them back at TRASH)."""
        ps = self.page_tokens
        keep_pages = (keep_rows + ps - 1) // ps
        pages = self.slot_pages[slot]
        freed = list(range(keep_pages, len(pages)))
        for pid in pages[keep_pages:]:
            self._decref(pid)
        del pages[keep_pages:]
        self.covered[slot] = min(self.covered[slot], keep_rows)
        return freed

    # -- sharing (prefix cache) -----------------------------------------

    def share(self, slot: int, npages: int) -> list[int]:
        """Reference the slot's first ``npages`` pages (a prefix entry
        publishing from freshly-prefilled rows — zero device copies; the
        pages outlive the slot via their refcount)."""
        out = list(self.slot_pages[slot][:npages])
        if len(out) < npages:
            raise ValueError(
                f"slot {slot} holds {len(out)} pages, cannot share {npages}"
            )
        self.incref_pages(out)
        return out

    def adopt(self, slot: int, shared: list[int], covered_rows: int) -> None:
        """Point the slot's leading table positions at shared pages (a
        prefix-cache seed: the device-to-device seed copy of the old
        pool becomes this pure table rewrite). The slot must hold no
        pages (release_from(slot, 0) first)."""
        if self.slot_pages[slot]:
            raise ValueError(f"slot {slot} still holds pages; release first")
        self.incref_pages(shared)
        self.slot_pages[slot] = list(shared)
        self.covered[slot] = covered_rows

    def table_row(self, slot: int, num_positions: int) -> list[int]:
        """The slot's full table row, padded with its shard's trash page —
        always written whole so the device update is one fixed-shape
        scatter."""
        pages = self.slot_pages[slot]
        return pages + [self.base(slot) + TRASH] * (num_positions - len(pages))

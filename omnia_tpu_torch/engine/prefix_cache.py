"""Cross-session shared-prefix KV pool (port of
``omnia_tpu/engine/prefix_cache.py``).

Every agent is a prompt pack, so every new session of one agent
prefills the same system block. The session registry (sessions.py)
reuses rows across the turns of one session; this module adds the
cross-session tier: a pool of refcounted, LRU-evicted prefix rows keyed
by a radix tree over token ids.

Residency of one cached prefix:

- **device pool**: on a contiguous cache, rows live in a dedicated
  ``[L, P, R, H, D]`` pool beside the slot cache (``_pk``/``_pv``, in the
  cache's representation); a hit copies them into the fresh session's
  slot (``prefix_seed``). On a paged cache the entry is a refcounted run
  of the one pool's pages: publish shares the slot's pages, a hit points
  the new slot's table at them, and the first write into a shared page
  copies it (engine/paged.py).
- **host tier**: rows demoted off the device into host RAM; a hit pages
  them back and promotes the entry to the device again.
- **dropped**: evicted; the next session prefills and may publish again.

A prefix enters the pool once the radix tree has seen it as the LCP of
``prefix_cache_publish_threshold`` fresh prompts, or on first sight when
registered (``register_prefix``). Eviction is LRU over entries that no
resident seeder holds. :class:`PrefixPool` is the host-side books, a
copy of the JAX package's; ``_PrefixCacheMixin`` wires placement,
publish and refcounts into :class:`InferenceEngine`.

Under data parallelism the contiguous pool's entries split over dp like
the slots (entry ``j`` on shard ``j // (prefix_cache_slots // dp)``) and
the books stay whole on every rank. A store or seed between a slot and
an entry of one shard runs there; across shards the source's owner reads
the rows, broadcasts them over dp, and the destination's owner writes
them. A demoted entry's host rows are on every rank (paged entries:
engine/paged.py).
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Optional

from omnia_tpu_torch.models.kv_quant import kv_device, kv_host

logger = logging.getLogger(__name__)

# Observation-tree node budget: past this the tree is rebuilt from entry
# and registered paths only (observations are a publish heuristic, not
# state — pruning them can only delay a publish, never corrupt one).
MAX_OBSERVED_NODES = 4096


class _RadixNode:
    """Path-compressed radix-tree node over token ids."""

    __slots__ = ("edge", "children", "entry", "passes")

    def __init__(self, edge: list[int]):
        self.edge = edge                      # tokens from parent to here
        self.children: dict[int, _RadixNode] = {}
        self.entry: Optional[PrefixEntry] = None
        self.passes = 0                       # prompts observed through here


class PrefixEntry:
    """One cached prefix: token ids + where its KV rows live."""

    __slots__ = (
        "key", "tokens", "bucket", "pool_idx", "pages", "host_k", "host_v",
        "refs", "hits", "last_used", "registered",
    )

    def __init__(self, key: int, tokens: tuple, bucket: int, now: float,
                 registered: bool = False):
        self.key = key
        self.tokens = tokens                  # the rows KNOWN valid
        self.bucket = bucket                  # fixed transfer shape
        self.pool_idx: Optional[int] = None   # device pool slot
        # Paged engine (EngineConfig.kv_pages): the refcounted page run
        # holding this prefix's rows in the ONE shared device pool —
        # publish shares the prefill slot's pages (zero copies), seed
        # points a fresh slot's table at them, and divergent writes
        # copy-on-write. pool_idx stays None in that mode; bucket holds
        # the page-run transfer bucket for the host tier.
        self.pages: Optional[list[int]] = None
        # Paged tier: numpy rows, or a QuantKV of numpy leaves when the
        # engine runs kv_quant (the host tier inherits the KV dtype, so
        # its entry budget buys 2× the rows under int8). Under kv_pages
        # the host arrays hold whole pages ([L, bucket, PAGE_S, H, D]),
        # verbatim.
        self.host_k = None
        self.host_v = None
        self.refs = 0                         # resident seeders
        self.hits = 0
        self.last_used = now
        self.registered = registered

    @property
    def on_device(self) -> bool:
        return self.pool_idx is not None or self.pages is not None


class PrefixPool:
    """Host-side books of the shared-prefix pool: radix index, entry
    registry, refcounts, device-slot free list, host-paged tier, and the
    publish heuristic. Engine-thread-owned (same discipline as the
    session registry); all decisions are deterministic functions of the
    event stream + the injected logical clock, so multi-host lockstep
    replicas stay in sync."""

    def __init__(self, slots: int, host_entries: int, clock=None):
        self.slots = slots
        self.host_entries = host_entries
        self.clock = clock or time.monotonic
        self._free = list(range(slots))
        self._root = _RadixNode([])
        self._nodes = 1
        self._by_key: dict[int, PrefixEntry] = {}
        self._registered: list[tuple] = []
        self._keys = itertools.count()
        self.evictions = 0  # device-slot losses (demote or drop)
        # Paged engine: set to the page allocator's release so dropping
        # an entry that still holds a page run returns the references.
        self.page_release = None

    # -- radix index ---------------------------------------------------

    def match(self, tokens) -> tuple[Optional[PrefixEntry], int]:
        """Longest usable prefix of ``tokens`` in the pool: the deepest
        fully-matched entry, or a PARTIAL match against a deeper entry
        (its leading LCP rows are still valid — the seed copies the
        entry's bucket and the suffix prefill overwrites the rest)."""
        node, d = self._root, 0
        best: tuple[Optional[PrefixEntry], int] = (None, 0)
        while d < len(tokens):
            child = node.children.get(tokens[d])
            if child is None:
                break
            common = 0
            limit = min(len(child.edge), len(tokens) - d)
            while common < limit and child.edge[common] == tokens[d + common]:
                common += 1
            d += common
            if common < len(child.edge):
                # Diverged mid-edge: any entry in this subtree shares
                # exactly d leading tokens with the prompt.
                deep = self._first_entry(child)
                if deep is not None and d > best[1]:
                    best = (deep, d)
                return best
            node = child
            if node.entry is not None:
                best = (node.entry, d)
        # Prompt exhausted (or no child continues it): any entry deeper
        # in this node's subtree still shares exactly d leading tokens.
        if d > best[1]:
            for child in node.children.values():
                deep = self._first_entry(child)
                if deep is not None:
                    best = (deep, d)
                    break
        return best

    def _first_entry(self, node: _RadixNode) -> Optional[PrefixEntry]:
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    def observe(self, tokens, threshold: int) -> int:
        """Insert a fresh prompt into the radix tree and return the
        length of the deepest prefix now seen by >= ``threshold``
        prompts (0 if none) — the publish candidate."""
        node, d, candidate = self._root, 0, 0
        while d < len(tokens):
            child = node.children.get(tokens[d])
            if child is None:
                new = _RadixNode(list(tokens[d:]))
                new.passes = 1
                node.children[tokens[d]] = new
                self._nodes += 1
                break
            common = 0
            limit = min(len(child.edge), len(tokens) - d)
            while common < limit and child.edge[common] == tokens[d + common]:
                common += 1
            if common < len(child.edge):
                # Split the edge at the divergence/exhaustion point.
                mid = _RadixNode(child.edge[:common])
                mid.passes = child.passes
                child.edge = child.edge[common:]
                mid.children[child.edge[0]] = child
                node.children[tokens[d]] = mid
                self._nodes += 1
                d += common
                mid.passes += 1
                if mid.passes >= threshold:
                    candidate = d
                if d < len(tokens):
                    tail = _RadixNode(list(tokens[d:]))
                    tail.passes = 1
                    mid.children[tokens[d]] = tail
                    self._nodes += 1
                break
            d += common
            child.passes += 1
            if child.passes >= threshold:
                candidate = d
            node = child
        if self._nodes > MAX_OBSERVED_NODES:
            self._prune_observations()
        return candidate

    def _prune_observations(self) -> None:
        """Rebuild the tree from entry paths only (drop pure-observation
        nodes). Pass counts reset — a pending near-threshold prefix just
        needs to be seen again."""
        entries = list(self._by_key.values())
        self._root = _RadixNode([])
        self._nodes = 1
        for e in entries:
            node = self._attach_path(list(e.tokens))
            node.entry = e

    def _attach_path(self, tokens: list[int]) -> _RadixNode:
        """Walk/extend the tree to the node ending exactly at ``tokens``
        (splitting edges as needed); does not touch pass counts."""
        node, d = self._root, 0
        while d < len(tokens):
            child = node.children.get(tokens[d])
            if child is None:
                new = _RadixNode(list(tokens[d:]))
                node.children[tokens[d]] = new
                self._nodes += 1
                return new
            common = 0
            limit = min(len(child.edge), len(tokens) - d)
            while common < limit and child.edge[common] == tokens[d + common]:
                common += 1
            d += common
            if common < len(child.edge):
                mid = _RadixNode(child.edge[:common])
                mid.passes = child.passes
                child.edge = child.edge[common:]
                mid.children[child.edge[0]] = child
                node.children[tokens[d - common]] = mid
                self._nodes += 1
                if d == len(tokens):
                    return mid
                node = mid
                continue
            node = child
        return node

    # -- registered pack prefixes --------------------------------------

    def register(self, tokens: tuple) -> None:
        if tokens and tokens not in self._registered:
            self._registered.append(tokens)

    def registered_candidate(self, tokens) -> int:
        """Longest LCP between the prompt and any registered pack prefix
        (partial is fine — e.g. a per-user memory block diverging inside
        the registered system block still shares the head)."""
        best = 0
        for reg in self._registered:
            lcp, limit = 0, min(len(reg), len(tokens))
            while lcp < limit and reg[lcp] == tokens[lcp]:
                lcp += 1
            best = max(best, lcp)
        return best

    # -- entry lifecycle -----------------------------------------------

    def acquire_slot(self) -> tuple[Optional[int], Optional[PrefixEntry]]:
        """A free device pool slot, or (via LRU over refcount-0 entries)
        one reclaimed by demoting its entry — the DEMOTED ENTRY is
        returned with ``pool_idx`` still set so the caller can page its
        rows to host BEFORE the slot is overwritten. (None, None) when
        every entry is referenced (pinned rows are never freed)."""
        if self._free:
            return self._free.pop(), None
        victims = [
            e for e in self._by_key.values() if e.on_device and e.refs == 0
        ]
        if not victims:
            return None, None
        victim = min(victims, key=lambda e: e.last_used)
        self.evictions += 1
        return victim.pool_idx, victim

    def insert(self, tokens: tuple, bucket: int, pool_idx: int,
               registered: bool = False) -> PrefixEntry:
        entry = PrefixEntry(
            next(self._keys), tokens, bucket, self.clock(), registered
        )
        entry.pool_idx = pool_idx
        self._by_key[entry.key] = entry
        self._attach_path(list(tokens)).entry = entry
        return entry

    def demoted_to_host(self, entry: PrefixEntry, host_k, host_v) -> None:
        """Record a demotion; enforces the host-tier cap (LRU drop)."""
        if self.host_entries <= 0:
            self._drop(entry)
            return
        entry.host_k, entry.host_v = host_k, host_v
        paged = [
            e for e in self._by_key.values()
            if e.host_k is not None and e.refs == 0
        ]
        while len(paged) > self.host_entries:
            oldest = min(paged, key=lambda e: e.last_used)
            paged.remove(oldest)
            self._drop(oldest)

    def _drop(self, entry: PrefixEntry) -> None:
        self._by_key.pop(entry.key, None)
        node = self._find_node(list(entry.tokens))
        if node is not None and node.entry is entry:
            node.entry = None
        entry.host_k = entry.host_v = None
        if entry.pages is not None:
            if self.page_release is not None:
                self.page_release(entry.pages)
            entry.pages = None
        if entry.pool_idx is not None:
            self._free.append(entry.pool_idx)
            entry.pool_idx = None

    # Public alias: the paged engine drops stale entries (rebuild on
    # miss) and crash-reset zombies without reaching into privates.
    drop_entry = _drop

    def _find_node(self, tokens: list[int]) -> Optional[_RadixNode]:
        node, d = self._root, 0
        while d < len(tokens):
            child = node.children.get(tokens[d])
            if child is None:
                return None
            limit = min(len(child.edge), len(tokens) - d)
            if child.edge[:limit] != tokens[d:d + limit]:
                return None
            d += limit
            if limit < len(child.edge):
                return None
            node = child
        return node

    def incref(self, entry: PrefixEntry) -> None:
        entry.refs += 1

    def decref(self, key: Optional[int]) -> None:
        if key is None:
            return
        entry = self._by_key.get(key)
        if entry is not None and entry.refs > 0:
            entry.refs -= 1

    def on_device_reset(self) -> int:
        """The device pool died with the caches (crash recovery): drop
        every device-resident entry (host-paged ones survive — their
        rows live in host RAM). Returns the number dropped."""
        dead = [e for e in self._by_key.values() if e.on_device]
        for e in dead:
            e.pool_idx = None  # device rows are gone, nothing to free
            if e.host_k is None:
                self._drop(e)
        self._free = list(range(self.slots))
        self.evictions += len(dead)
        return len(dead)

    def entries(self) -> list[PrefixEntry]:
        return list(self._by_key.values())


class _PrefixCacheMixin:
    """Shared-prefix pool methods of :class:`InferenceEngine`; every one
    is a no-op while ``prefix_cache_slots == 0``."""

    def _prefix_enabled(self) -> bool:
        return self._prefix_pool is not None

    # -- registration (cross-thread, queued like release_session) ------

    def register_prefix(self, tokens) -> None:
        """Mark a token sequence as a pack prefix: it publishes into the
        pool on first sight instead of waiting for the publish threshold.
        Thread-safe: queued and applied at the next step."""
        if not self._prefix_enabled() or not tokens:
            return
        with self._lock:
            self._pending_prefix_regs.append(list(tokens))
        if self._thread is None:
            self._drain_prefix_regs()

    def _drain_prefix_regs(self) -> None:
        if not self._prefix_enabled():
            return
        with self._lock:
            regs, self._pending_prefix_regs = self._pending_prefix_regs, []
        rows = self.cfg.prefix_buckets()[-1]
        for tokens in regs:
            if len(tokens) >= self.cfg.prefix_cache_min_tokens:
                self._prefix_pool.register(tuple(tokens[:rows]))

    # -- placement: seed ------------------------------------------------

    def _try_seed_from_pool(self, slot_idx: int, prompt: list[int], sess) -> int:
        """Longest-prefix-match the pool and seed the slot with the shared
        rows; returns the seeded token count (0 = miss). The caller then
        prefills only prompt[matched:], enqueued after the seed on the
        same stream."""
        if not self._prefix_enabled():
            return 0
        entry, matched = self._prefix_pool.match(prompt)
        matched = min(matched, len(prompt) - 1)
        if entry is None or matched < self.cfg.prefix_cache_min_tokens:
            return 0
        if self._pages is not None:
            # Paged: a table rewrite onto the entry's page run; the
            # suffix's first write copies the shared boundary page.
            if not self._paged_adopt_entry(entry, slot_idx, matched):
                return 0
        elif entry.on_device:
            self._pool_seed(entry.pool_idx, slot_idx, entry.bucket)
        elif entry.host_k is not None:
            # Host tier: page the rows back through the slot restore, then
            # promote the entry while they are hot.
            li = self._dp.local(slot_idx)
            if li is not None:
                self._restore_fn(self._ck, self._cv, kv_device(entry.host_k, self.device),
                                 kv_device(entry.host_v, self.device), li)
            self.metrics["prefix_cache_host_hits"] += 1
            self._promote_entry(entry, slot_idx)
        else:
            return 0
        entry.hits += 1
        entry.last_used = self.clock()
        self.metrics["prefix_cache_hit_tokens"] += matched
        self._hold_seed_ref(entry, slot_idx, sess)
        return matched

    def _promote_entry(self, entry: PrefixEntry, slot_idx: int) -> None:
        idx, demoted = self._prefix_pool.acquire_slot()
        if idx is None:
            return
        if demoted is not None:
            self._demote_rows(demoted)
        self._pool_store(slot_idx, idx, entry.bucket)
        entry.pool_idx = idx
        entry.host_k = entry.host_v = None

    def _hold_seed_ref(self, entry: PrefixEntry, slot_idx: int, sess) -> None:
        """Pin the entry while its seeder is resident: a session holds it
        until the session drops, a sessionless slot until its finish."""
        if sess is not None:
            self._prefix_pool.decref(sess.seeded_from)
            sess.seeded_from = entry.key
        else:
            self._slots[slot_idx].seeded_from = entry.key
        self._prefix_pool.incref(entry)

    def _release_slot_seed(self, slot) -> None:
        """Drop a sessionless slot's seed pin (finish, fail, cancel)."""
        if slot.seeded_from is not None:
            if self._prefix_enabled():
                self._prefix_pool.decref(slot.seeded_from)
            slot.seeded_from = None

    def _prefix_decref(self, key: Optional[int]) -> None:
        if self._prefix_enabled():
            self._prefix_pool.decref(key)

    def _prefix_match_len(self, tokens) -> int:
        if not self._prefix_enabled() or not tokens:
            return 0
        return self._prefix_pool.match(tokens)[1]

    def _prefix_covered(self, tokens) -> bool:
        """True when the pool covers all of ``tokens``: an idle session's
        offload is then elided, its rows rebuilt by a seed next turn."""
        return bool(tokens) and self._prefix_match_len(tokens) >= len(tokens)

    # -- placement: publish ---------------------------------------------

    def _maybe_publish_prefix(self, slot_idx: int, prompt: list[int]) -> None:
        """After a prefill, publish this prompt's shared prefix from the
        slot's fresh rows: the longest registered pack prefix it matches,
        or the radix tree's LCP with earlier traffic once seen threshold
        times, if that extends at least min_tokens past what the pool
        already covers."""
        if not self._prefix_enabled():
            return
        pool = self._prefix_pool
        rows = self.cfg.prefix_buckets()[-1]
        head = prompt[:rows]
        candidate = pool.registered_candidate(head)
        registered = candidate > 0
        observed = pool.observe(head, self.cfg.prefix_cache_publish_threshold)
        if observed > candidate:
            candidate, registered = observed, False
        min_tokens = self.cfg.prefix_cache_min_tokens
        if candidate < min_tokens:
            return
        tokens = tuple(head[:candidate])
        _e, already = pool.match(tokens)
        if candidate - already < min_tokens:
            return
        if self._pages is not None:
            self._paged_publish(slot_idx, tokens, registered)
            return
        idx, demoted = pool.acquire_slot()
        if idx is None:
            return  # every entry is pinned by a resident seeder
        if demoted is not None:
            self._demote_rows(demoted)
        bucket = self.cfg.prefix_bucket_for(candidate)
        self._pool_store(slot_idx, idx, bucket)
        pool.insert(tokens, bucket, idx, registered)
        self.metrics["prefix_cache_insertions"] += 1

    def _demote_rows(self, entry: PrefixEntry) -> None:
        """Page a demoted entry's rows to the host tier. The copy to host
        completes before the vacated pool entry is overwritten."""
        k, v = self._pool_rows(entry.pool_idx, entry.bucket)
        entry.pool_idx = None
        self._prefix_pool.demoted_to_host(entry, kv_host(k), kv_host(v))
        self.metrics["prefix_cache_evictions"] = self._prefix_pool.evictions

    # -- transfers between slots and pool entries ----------------------

    def _pool_rows(self, idx: int, rows: int):
        """Pool entry ``idx``'s rows [0, rows) as [L, rows, H, D] on every
        rank: its dp shard's read, broadcast over dp."""
        lp = self._dp_pool.local(idx)
        return self._rows_from(self._dp_pool.owner(idx),
                               lambda: self._prefix_offload_fn(self._pk, self._pv, lp, rows),
                               self._rows_like(self._pk, (rows,), 3))

    def _pool_store(self, slot_idx: int, idx: int, rows: int) -> None:
        """A slot's rows [0, rows) → pool entry ``idx``: the store program
        where one dp shard holds both, else the slot's rows broadcast
        from its shard and written into the entry by the entry's."""
        ls, lp = self._dp.local(slot_idx), self._dp_pool.local(idx)
        if self._dp.owner(slot_idx) == self._dp_pool.owner(idx):
            if ls is not None:
                self._prefix_store_fn(self._pk, self._pv, self._ck, self._cv, ls, lp, rows)
            return
        k, v = self._slot_rows(slot_idx, rows)
        if lp is not None:
            self._restore_fn(self._pk, self._pv, k, v, lp)

    def _pool_seed(self, idx: int, slot_idx: int, rows: int) -> None:
        """Pool entry ``idx``'s rows [0, rows) → a slot: the seed program
        where one dp shard holds both, else the entry's rows broadcast
        from its shard and written into the slot by the slot's."""
        ls, lp = self._dp.local(slot_idx), self._dp_pool.local(idx)
        if self._dp.owner(slot_idx) == self._dp_pool.owner(idx):
            if ls is not None:
                self._prefix_seed_fn(self._ck, self._cv, self._pk, self._pv, lp, ls, rows)
            return
        k, v = self._pool_rows(idx, rows)
        if ls is not None:
            self._restore_fn(self._ck, self._cv, k, v, ls)

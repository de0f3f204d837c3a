"""Data-parallel slot shards for the serving engine (the port's explicit
form of what GSPMD does for the JAX engine's ``P(None, "dp", ...)``
layouts).

Under ``EngineConfig.dp`` the slot batch, the KV cache and the
shared-prefix pool are split over "dp" in blocks: slot ``i`` belongs to
shard ``i // (num_slots // dp)``, pool entry ``j`` to shard ``j //
(prefix_cache_slots // dp)``, and a paged cache holds ``kv_pages // dp``
pages per shard. Each rank allocates only its shard's rows, and its
per-slot device state and decode programs run at the local batch
``num_slots // dp``. The host books (slots, sessions, page books, the
prefix pool, the LRU and its logical clock) stay whole and equal on
every rank, so every rank makes the same decisions.

What GSPMD does implicitly becomes an explicit step here, called by
every rank of the dp group at the same point of the same step:

- a slot-addressed program (prefill, extend, offload, restore, a prefix
  store or seed) runs on the owner shard's ranks only, at the slot's
  local row; the other shards' ranks skip it, and none of their
  collectives pair with the owner's, since each shard has its own tp
  (and sp) groups;
- the owner's first token goes to every shard by one broadcast over dp
  (``_first_token``), so every rank's books emit it;
- each decode chunk's ``[K, num_slots // dp]`` tokens are gathered over
  dp into the global ``[K, num_slots]`` (``SlotShards.gather``);
- rows read on one shard and needed on another (a session's rows on
  offload, a prefix entry seeding a slot of another shard) are read by
  their owner and broadcast over dp (``_rows_from``).

At ``dp = 1`` every helper here is the identity and launches nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from omnia_tpu_torch.models.kv_quant import kv_map
from omnia_tpu_torch.parallel.collectives import Comm, all_gather


class SlotShards:
    """Which dp shard owns which block of ``n`` rows (slots, pool entries
    or pages), and this rank's block. ``comm`` is the "dp" axis's Comm
    (None at dp = 1)."""

    def __init__(self, n: int, dp: int = 1, index: int = 0, comm: Optional[Comm] = None):
        self.per = n // dp
        self.index = index
        self.lo = index * self.per
        self.hi = self.lo + self.per
        self.comm = comm

    def owner(self, i: int) -> int:
        return i // self.per

    def local(self, i: int) -> Optional[int]:
        """Row ``i``'s index in this rank's block, None on other shards."""
        return i - self.lo if self.lo <= i < self.hi else None

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every shard's x joined along ``dim`` in shard order."""
        return all_gather(x, self.comm, dim=dim)

    def bcast(self, x: torch.Tensor, shard: int) -> torch.Tensor:
        """Shard ``shard``'s x on every shard (x is read there only)."""
        return x if self.comm is None else self.comm.broadcast(x, shard)


class _DataParallelMixin:
    """The dp moves of :class:`InferenceEngine`. ``self._dp`` holds the
    slot shards; a contiguous prefix pool's entries use ``self._dp_pool``."""

    def _first_token(self, tok: Optional[torch.Tensor], slot_idx: int) -> torch.Tensor:
        """The owner shard's first token (0-d int32) on every rank: one
        broadcast over dp, from a placeholder on the other shards."""
        if self._dp.comm is None:
            return tok
        if tok is None:
            tok = torch.zeros((), dtype=torch.int32, device=self.device)
        return self._dp.bcast(tok, self._dp.owner(slot_idx))

    def _rows_from(self, shard: int, read: Callable, like: Callable):
        """A (k, v) pair of device rows read by ``read()`` on shard
        ``shard``'s ranks, on every rank: broadcast over dp from there,
        into ``like()``'s placeholders (same shapes and representation)
        elsewhere. At dp = 1 ``read()`` itself."""
        if self._dp.comm is None:
            return read()
        kv = read() if shard == self._dp.index else like()
        return tuple(kv_map(lambda a: self._dp.bcast(a, shard), x) for x in kv)

    def _rows_like(self, cache, lead: tuple, skip: int):
        """A callable making (k, v) placeholders shaped like ``cache``'s
        leaves with dims [1, skip) replaced by ``lead``: (rows,), 3 gives
        [L, rows, H, D] session rows of a slot cache or a page pool; (n,),
        2 a run of n pages [L, n, R, H, D]."""
        def like():
            def empty(a):
                shape = (a.shape[0],) + tuple(lead) + tuple(a.shape[skip:])
                return torch.empty(shape, dtype=a.dtype, device=a.device)
            return kv_map(empty, cache), kv_map(empty, cache)
        return like

    def _slot_rows(self, slot_idx: int, rows: int):
        """A slot's rows [0, rows) as [L, rows, H, D] (cache representation)
        on every rank: the owner's offload, broadcast over dp."""
        li = self._dp.local(slot_idx)
        cache = self._ck.pool if self.cfg.kv_pages > 0 else self._ck
        return self._rows_from(self._dp.owner(slot_idx),
                               lambda: self._offload_fn(self._ck, self._cv, li, rows),
                               self._rows_like(cache, (rows,), 3))

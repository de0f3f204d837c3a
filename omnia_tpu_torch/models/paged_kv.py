"""Paged KV cache device layout (port of ``omnia_tpu/models/paged_kv.py``).

Rows live in one fixed pool ``[L, P, PAGE_S, Hkv, D]`` (a plain tensor,
or a QuantKV with ``[L, P, PAGE_S, Hkv]`` scales under ``kv_quant``),
ordered per slot by an int32 page table ``[B, max_seq / PAGE_S]``: row
``s`` of slot ``b`` lives at ``pool[:, table[b, s // PAGE_S], s %
PAGE_S]``. The host keeps the books (``engine/kv_pages.py``); everything
here is a gather or an in-place scatter through a table the host has
already made consistent.

Reads: on the card a decode step reads pages through the table inside
the kernel (``ops/decode_attention.py``); every other read materializes
the slot-contiguous view with :func:`gather_view` and runs the
contiguous math, which keeps paged and contiguous serving bit-identical
there. Writes quantize through the same ``quantize_rows`` as the
contiguous cache, so int8 rows are bit-identical across layouts.
"""

from __future__ import annotations

from typing import Any

import torch

from omnia_tpu_torch.models.kv_quant import is_quant_kv, kv_map, quantize_rows


class PagedKV:
    """One paged KV cache: pool rows + the page table that orders them.
    In the engine k and v share one table tensor."""

    __slots__ = ("pool", "table")

    def __init__(self, pool: Any, table: torch.Tensor) -> None:
        self.pool = pool
        self.table = table

    @property
    def shape(self) -> tuple[int, ...]:
        """The logical (slot-contiguous) shape ``[..., B, S, Hkv, D]``."""
        q = self.pool.q if is_quant_kv(self.pool) else self.pool
        *lead, _p, ps, h, d = q.shape
        b, np_ = self.table.shape
        return (*lead, b, np_ * ps, h, d)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def page_tokens(self) -> int:
        q = self.pool.q if is_quant_kv(self.pool) else self.pool
        return int(q.shape[-3])

    @property
    def nbytes(self) -> int:
        return int(self.pool.nbytes + self.table.nbytes)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PagedKV(pool={self.pool!r}, table={tuple(self.table.shape)})"


def is_paged(x: Any) -> bool:
    return isinstance(x, PagedKV)


def gather_view(cache: PagedKV) -> Any:
    """Per-layer paged cache → the slot-contiguous view ``[B, S, Hkv,
    D]`` (QuantKV when quantized), values copied verbatim."""
    table = cache.table.long()  # [B, NP]

    def g(arr):  # arr [P, PS, ...]
        out = arr[table]  # [B, NP, PS, ...]
        s = out.shape
        return out.reshape((s[0], s[1] * s[2]) + s[3:])

    return kv_map(g, cache.pool)


def gather_slot(cache: PagedKV, slot: int) -> Any:
    """Engine-level paged cache → one slot's rows ``[L, 1, S, Hkv, D]``,
    copied (the JAX package's extend seam; the port's extend runs on the
    one-row table view ``PagedKV(pool, table[slot:slot+1])`` instead)."""
    row = cache.table[slot:slot + 1].long()  # [1, NP]

    def g(arr):  # arr [L, P, PS, ...]
        out = arr[:, row]  # [L, 1, NP, PS, ...]
        s = out.shape
        return out.reshape(s[:2] + (s[2] * s[3],) + s[4:])

    return kv_map(g, cache.pool)


def gather_rows(cache: PagedKV, slot: int, rows: int) -> Any:
    """One slot's leading ``rows`` rows → ``[L, rows, Hkv, D]``: only the
    pages covering them are read, into the contiguous engine's host
    offload layout."""
    ps = cache.page_tokens
    row = cache.table[slot, :-(-rows // ps)].long()  # [npg]

    def g(arr):  # arr [L, P, PS, ...]
        out = arr[:, row]  # [L, npg, PS, ...]
        s = out.shape
        return out.reshape((s[0], s[1] * s[2]) + s[3:])[:, :rows]

    return kv_map(g, cache.pool)


def gather_pages(pool: Any, idx: torch.Tensor) -> Any:
    """Pool pages ``idx [n]`` → ``[L, n, PAGE_S, ...]``, copied verbatim
    (the prefix host tier's demotion)."""
    return kv_map(lambda arr: arr[:, idx.long()], pool)


def scatter_pages(pool: Any, idx: torch.Tensor, pages: Any) -> None:
    """In place: pool pages ``idx [n]`` ← ``pages [L, n, PAGE_S, ...]``,
    verbatim (the prefix host tier's promotion)."""
    i = idx.long()
    if is_quant_kv(pool):
        pool.q[:, i] = pages.q.to(pool.q.dtype)
        pool.s[:, i] = pages.s.to(pool.s.dtype)
    else:
        pool[:, i] = pages.to(pool.dtype)


def copy_page(pool: Any, src: int, dst: int) -> None:
    """In place: pool page ``dst`` ← page ``src`` over all layers, the
    device half of copy-on-write."""
    def one(arr):  # [L, P, PS, ...]
        arr[:, dst].copy_(arr[:, src])
        return arr

    kv_map(one, pool)


def _flat_scatter(arr: torch.Tensor, flat_idx: torch.Tensor, vals: torch.Tensor,
                  lead: int) -> None:
    """In place: rows of pool ``arr [*lead, P, PS, rest]`` at ``flat_idx``
    into the flattened P*PS row axis ← ``vals [*lead, *idx_shape, rest]``."""
    s = arr.shape
    a2 = arr.view(s[:lead] + (s[lead] * s[lead + 1],) + s[lead + 2:])
    if lead == 0:
        a2[flat_idx] = vals
    else:
        a2[:, flat_idx] = vals


def flat_rows(table: torch.Tensor, page_tokens: int, start: torch.Tensor,
              t: int) -> torch.Tensor:
    """Where rows [start, start + t) of each slot live in the flattened
    [P*PS] row axis of the pool: ``[B, T]``. Each row is clamped to
    ``NP*PS - 1`` (the start is not shifted, unlike the contiguous write)."""
    ps = page_tokens
    r = start.to(torch.long)[:, None] + torch.arange(t, device=table.device)[None, :]
    r = torch.clamp(r, max=table.shape[1] * ps - 1)             # [B, T]
    page = torch.gather(table.long(), 1, r // ps)
    return page * ps + r % ps


def scatter_rows(pool: Any, flat: torch.Tensor, new: Any) -> None:
    """In place: per-layer pool ``[P, PS, Hkv, D]`` rows ``flat [B, T]`` ←
    ``new [B, T, Hkv, D]``, quantized here iff the pool is int8."""
    if is_quant_kv(pool):
        qn = new if is_quant_kv(new) else quantize_rows(new)
        _flat_scatter(pool.q, flat, qn.q.to(pool.q.dtype), 0)
        _flat_scatter(pool.s, flat, qn.s.to(pool.s.dtype), 0)
    else:
        _flat_scatter(pool, flat, new.to(pool.dtype), 0)


def write_rows(cache: PagedKV, new: Any, start: torch.Tensor) -> PagedKV:
    """The paged ``llama._write_kv``: per-layer pool ``[P, PS, Hkv, D]`` ←
    rows ``[B, T, Hkv, D]`` at per-slot row offsets ``start [B]``,
    through the table, in place (rows clamped as in :func:`flat_rows`)."""
    t = new.q.shape[1] if is_quant_kv(new) else new.shape[1]
    scatter_rows(cache.pool, flat_rows(cache.table, cache.page_tokens, start, t), new)
    return cache


def put_chunk(cache: PagedKV, chunk: Any, slot: int, start: int) -> PagedKV:
    """Engine-level paged cache ← one slot's chunk ``[L, 1, T, Hkv, D]``
    at rows [start, start+T), in place (the paged ``cache_put``). A
    float chunk is quantized here iff the pool is."""
    table, pool = cache.table, cache.pool
    ps = cache.page_tokens
    np_ = table.shape[1]
    t = chunk.q.shape[2] if is_quant_kv(chunk) else chunk.shape[2]
    r = torch.clamp(start + torch.arange(t, device=table.device), max=np_ * ps - 1)
    flat = table[slot].long()[r // ps] * ps + r % ps            # [T]

    if is_quant_kv(pool):
        qc = chunk if is_quant_kv(chunk) else quantize_rows(chunk)
        _flat_scatter(pool.q, flat, qc.q[:, 0].to(pool.q.dtype), 1)
        _flat_scatter(pool.s, flat, qc.s[:, 0].to(pool.s.dtype), 1)
    else:
        if is_quant_kv(chunk):
            raise TypeError("quantized chunk written into an unquantized pool")
        _flat_scatter(pool, flat, chunk[:, 0].to(pool.dtype), 1)
    return cache

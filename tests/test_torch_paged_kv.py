"""Paged KV cache: the port's page books (``engine/kv_pages.py``) and
device layout (``models/paged_kv.py``) held against the JAX package's on
the CPU. The books must take the same decisions for the same calls; the
gathers and scatters must give the same values (tolerance 0)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.engine import kv_pages as jpages
from omnia_tpu.models import kv_quant as jkvq
from omnia_tpu.models import paged_kv as jpkv
from omnia_tpu_torch.engine import kv_pages as tpages
from omnia_tpu_torch.models import kv_quant as tkvq
from omnia_tpu_torch.models import paged_kv as tpkv

# Call sequences of tests/test_kv_pages.py::TestPageAllocator, as
# (allocator args, [(method, args), ...]).
SCRIPTS = {
    "alloc_release": ((6, 16, 2), [("alloc_pages", (3,)), ("release_pages", ([1, 2, 3],))]),
    "prepare_write": ((8, 16, 2), [("prepare_write", (0, 0, 40)),
                                   ("prepare_write", (0, 40, 48)),
                                   ("prepare_write", (0, 48, 49))]),
    "release_from": ((8, 16, 2), [("prepare_write", (0, 0, 64)),
                                  ("release_from", (0, 20)),
                                  ("release_from", (0, 0))]),
    "share_adopt_cow": ((10, 16, 2), [("prepare_write", (0, 0, 40)),
                                      ("share", (0, 3)),
                                      ("adopt", (1, [1, 2, 3], 36)),
                                      ("prepare_write", (1, 36, 70)),
                                      ("prepare_write", (0, 10, 40))]),
    "writes_needed": ((8, 16, 2), [("writes_needed", (0, 0, 40)),
                                   ("prepare_write", (0, 0, 40)),
                                   ("writes_needed", (0, 0, 40)),
                                   ("incref_pages", ([2],)),
                                   ("writes_needed", (0, 16, 40))]),
    "exhaustion": ((3, 16, 1), [("prepare_write", (0, 0, 32)),
                                ("prepare_write", (0, 32, 64))]),
    "fragmentation": ((8, 16, 2), [("prepare_write", (0, 0, 8)),
                                   ("prepare_write", (1, 0, 16)),
                                   ("release_from", (0, 0))]),
}


def _state(a, num_positions=6):
    return dict(tables=[a.table_row(s, num_positions) for s in range(len(a.slot_pages))],
                free=a.free_count, total=a.total, refs=dict(a.refs),
                frag=a.fragmentation(), covered=list(a.covered), cow=a.cow_copies)


def _call(a, method, args):
    try:
        return getattr(a, method)(*args)
    except (jpages.PoolExhausted, tpages.PoolExhausted) as e:
        return ("exhausted", str(e))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_allocator_replays_jax(name):
    ctor, calls = SCRIPTS[name]
    ja, ta = jpages.PageAllocator(*ctor), tpages.PageAllocator(*ctor)
    assert _state(ta) == _state(ja)
    for method, args in calls:
        assert _call(ta, method, args) == _call(ja, method, args), method
        assert _state(ta) == _state(ja), method
    assert tpages.TRASH == jpages.TRASH == 0


def test_allocator_refuses_what_jax_refuses():
    for args in ((1, 16, 2), (4, 0, 2)):
        with pytest.raises(ValueError) as je:
            jpages.PageAllocator(*args)
        with pytest.raises(ValueError) as te:
            tpages.PageAllocator(*args)
        assert str(te.value) == str(je.value)


# -- device layout ----------------------------------------------------------

L, B, PS, NP, H, D = 2, 3, 4, 4, 2, 16
P = 16


def _pool_and_table(seed=0, quant=False):
    """A scrambled pool (every page filled with distinct values) and a
    table whose rows reference shuffled pages, page 0 (trash) included."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((L, P, PS, H, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[: B * NP].reshape(B, NP).astype(np.int32)
    table[2, 3] = 0
    if quant:
        qp = jkvq.quantize_rows_np(pool)
        return qp, table
    return pool, table


def _jax_cache(pool, table):
    if isinstance(pool, jkvq.QuantKV):
        pool = jkvq.QuantKV(jnp.asarray(pool.q), jnp.asarray(pool.s))
    else:
        pool = jnp.asarray(pool)
    return jpkv.PagedKV(pool, jnp.asarray(table))


def _torch_cache(pool, table):
    if isinstance(pool, jkvq.QuantKV):
        pool = tkvq.QuantKV(torch.from_numpy(pool.q.copy()), torch.from_numpy(pool.s.copy()))
    else:
        pool = torch.from_numpy(pool.copy())
    return tpkv.PagedKV(pool, torch.from_numpy(table.copy()))


def _leaves(pool):
    if isinstance(pool, (jkvq.QuantKV, tkvq.QuantKV)):
        return [np.asarray(pool.q), np.asarray(pool.s)]
    return [np.asarray(pool)]


def _assert_same(tpool, jpool):
    for t, j in zip(_leaves(tpool), _leaves(jpool)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("quant", [False, True])
def test_gather_view_matches_jax(quant):
    pool, table = _pool_and_table(quant=quant)
    jc, tc = _jax_cache(pool, table), _torch_cache(pool, table)
    jl = jpkv.PagedKV(_layer(jc.pool, 1), jc.table)
    tl = tpkv.PagedKV(_layer(tc.pool, 1), tc.table)
    assert tl.shape == jl.shape == (B, NP * PS, H, D)
    assert tc.shape == jc.shape and tc.page_tokens == jc.page_tokens == PS
    assert tc.nbytes == jc.nbytes
    _assert_same(tpkv.gather_view(tl), jpkv.gather_view(jl))


def _layer(pool, i):
    if isinstance(pool, (jkvq.QuantKV, tkvq.QuantKV)):
        return type(pool)(pool.q[i], pool.s[i])
    return pool[i]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T,starts", [
    (1, [3, 0, 9]),
    (3, [0, 5, 13]),      # slot 2 crosses into its trash-mapped last page
    (1, [15, 20, 2]),     # slot 1 past the end: clamped to row NP*PS - 1
])
def test_write_rows_matches_jax(quant, T, starts):
    pool, table = _pool_and_table(seed=1, quant=quant)
    jc, tc = _jax_cache(pool, table), _torch_cache(pool, table)
    new = np.random.default_rng(3).standard_normal((B, T, H, D)).astype(np.float32)
    start = np.array(starts, np.int32)
    jl = jpkv.PagedKV(_layer(jc.pool, 0), jc.table)
    tl = tpkv.PagedKV(_layer(tc.pool, 0), tc.table)
    jout = jpkv.write_rows(jl, jnp.asarray(new), jnp.asarray(start))
    tout = tpkv.write_rows(tl, torch.from_numpy(new), torch.from_numpy(start))
    _assert_same(tout.pool, jout.pool)
    # In place: the engine-level pool saw the write.
    _assert_same(_layer(tc.pool, 0), jout.pool)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("slot,start,T", [(0, 0, 8), (1, 3, 9), (2, 10, 8)])
def test_put_chunk_matches_jax(quant, slot, start, T):
    """(2, 10, 8): rows 10..17 of a 16-row slot, the last two clamped."""
    pool, table = _pool_and_table(seed=2, quant=quant)
    jc, tc = _jax_cache(pool, table), _torch_cache(pool, table)
    chunk = np.random.default_rng(4).standard_normal((L, 1, T, H, D)).astype(np.float32)
    if T == 8 and start == 10:
        chunk[:, :, 6:] = chunk[:, :, 5:6]  # clamped rows land on one row: same values
    jout = jpkv.put_chunk(jc, jnp.asarray(chunk), slot, start)
    tout = tpkv.put_chunk(tc, torch.from_numpy(chunk), slot, start)
    assert tout is tc
    _assert_same(tout.pool, jout.pool)

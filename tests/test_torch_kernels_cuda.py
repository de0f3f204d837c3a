"""Decode-attention kernels (K1–K4) against their plain versions, and
the int8-weight products against their CPU route, on a card. This file imports neither jax nor omnia_tpu (the machine with the
card has neither), so run it there without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Here, on a host without a card, every test skips. The helpers build the
inputs that test_torch_decode_attention.py also feeds the JAX kernels."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from omnia_tpu_torch.models import quant as tquant
from omnia_tpu_torch.models.kv_quant import quantize_rows, quantize_rows_np
from omnia_tpu_torch.ops import decode_attention as tda

# Positions 0, mid-block and S-1 (block_s = 128 in the JAX kernel).
POSITIONS = [0, 77, 255]
PAGE_S = 64


def inputs(B=3, S=256, H=8, Hkv=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def quant(k, v):
    """int8 rows and f32 row scales of k and v (bit-identical to JAX's)."""
    qk, qv = quantize_rows_np(k), quantize_rows_np(v)
    return qk.q, qv.q, qk.s, qv.s


def paginate(arrs, positions, free_pages=3, seed=7, page_s=PAGE_S):
    """Scatter contiguous [B, S, ...] arrays into a scrambled page pool
    (the layout of tests/test_decode_attention.py::_paginate): pool page
    0 is the trash page and pages 1..free_pages-1 stay free; table
    entries past each position's page point at trash."""
    B, S = arrs[0].shape[:2]
    npg = S // page_s
    perm = np.random.RandomState(seed).permutation(B * npg) + free_pages
    pools = [np.zeros((B * npg + free_pages, page_s) + a.shape[2:], a.dtype)
             for a in arrs]
    table = np.zeros((B, npg), np.int32)
    for b in range(B):
        for j in range(positions[b] // page_s + 1):
            pid = int(perm[b * npg + j])
            for pool, a in zip(pools, arrs):
                pool[pid] = a[b, j * page_s:(j + 1) * page_s]
            table[b, j] = pid
    return pools, table


def poison_unreferenced(pools, table, positions, nan_int8=127, page_s=PAGE_S):
    """NaN (or a huge int8) in every pool page the table does not
    reference for a live row (free pages and the trash page) and in the
    referenced rows past each position."""
    live = {int(table[b, j]) for b, p in enumerate(positions) for j in range(p // page_s + 1)}
    out = []
    for pool in pools:
        bad = nan_int8 if pool.dtype == np.int8 else np.nan
        pool = pool.copy()
        for pid in range(pool.shape[0]):
            if pid not in live:
                pool[pid] = bad
        for b, p in enumerate(positions):
            pool[table[b, p // page_s], p % page_s + 1:] = bad
        out.append(pool)
    return out


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def check_editions(dtype, atol, positions, S, H, Hkv, D, page_s=PAGE_S, seed=0):
    """K1–K4 on one set of inputs against their plain versions, with every
    row past a position, every free page and the trash page poisoned (NaN;
    127 in int8 rows); each call launches its kernel once. With pages of
    SPLIT_ROWS rows the paged editions equal the contiguous ones bit for
    bit (same tiles, same arithmetic)."""
    dev = "cuda"
    B = len(positions)
    q, k, v = inputs(B=B, S=S, H=H, Hkv=Hkv, D=D, seed=seed)
    kq, vq, ks, vs = quant(k, v)
    past = np.arange(S)[None, :] > np.asarray(positions)[:, None]    # [B, S]
    for a, bad in ((k, np.nan), (v, np.nan), (kq, 127), (vq, -127), (ks, np.nan),
                   (vs, np.nan)):
        a[past] = bad
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    tq = torch.from_numpy(q).to(dev, dtype)
    outs = {}
    for int8 in (False, True):
        for paged in (False, True):
            arrs = [kq, vq, ks, vs] if int8 else [k, v]
            if paged:
                arrs, table = paginate(arrs, positions, page_s=page_s)
                arrs = poison_unreferenced(arrs, table, positions, page_s=page_s)
            t = [torch.from_numpy(a).to(dev) for a in arrs]
            if not int8:
                t = [x.to(dtype) for x in t]
            sc = dict(k_scale=t[2], v_scale=t[3]) if int8 else {}
            name = tda.edition(int8, paged)
            before = tda.LAUNCHES[name]
            if paged:
                tt = torch.from_numpy(table).to(dev)
                out = tda.decode_gqa_attention_paged(tq, t[0], t[1], tt, pos, **sc)
                ref = tda.decode_gqa_attention_paged_ref(tq, t[0], t[1], tt, pos, **sc)
            else:
                out = tda.decode_gqa_attention(tq, t[0], t[1], pos, **sc)
                ref = (tda.decode_gqa_attention_quant_ref(tq, *t, pos) if int8
                       else tda.decode_gqa_attention_ref(tq, *t, pos))
            torch.cuda.synchronize()
            assert tda.LAUNCHES[name] == before + 1, name
            assert torch.isfinite(out).all(), f"{name}: a poisoned row was read"
            torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0,
                                       msg=lambda m: f"{name}: {m}")
            outs[name] = out
    if page_s == tda.SPLIT_ROWS:
        for paged, contiguous in (("decode_attention_paged", "decode_attention"),
                                  ("decode_attention_paged_int8", "decode_attention_int8")):
            torch.testing.assert_close(outs[paged], outs[contiguous], atol=0, rtol=0)


# f32: summation order only; bf16: two bf16 ulps at magnitude 1.
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cuda_kernel_matches_plain(dtype, atol, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in inputs(B=4, S=300, H=8, Hkv=1 if D == 16 else 2, D=D))
    pos = torch.tensor([0, 63, 64, 299], dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos.tolist()):
        k[b, p + 1:] = float("nan")
        v[b, p + 1:] = float("nan")
    before = tda.LAUNCHES["decode_attention"]
    out = tda.decode_gqa_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["decode_attention"] == before + 1
    ref = tda.decode_gqa_attention_ref(q, k, v, pos)
    # f32: summation order only; bf16: two bf16 ulps at magnitude 1.
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_cuda_new_editions_match_plain(dtype, atol, D):
    """K2, K3 and K4 against their plain versions with everything past a
    position, every free page and the trash page poisoned; K3 is
    bit-identical to K1 over the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    Hkv = 1 if D == 16 else 2
    q, k, v = inputs(B=3, S=256, H=8, Hkv=Hkv, D=D, seed=8)
    dev = "cuda"
    pos = torch.tensor(POSITIONS, dtype=torch.int32, device=dev)
    tq = torch.from_numpy(q).to(dev, dtype)
    kq, vq, ks, vs = quant(k, v)

    def launched(name, fn):
        before = tda.LAUNCHES[name]
        out = fn()
        torch.cuda.synchronize()
        assert tda.LAUNCHES[name] == before + 1, name
        return out

    # K2
    kp, vp, ksp, vsp = (torch.from_numpy(a).to(dev) for a in (kq, vq, ks, vs))
    for b, p in enumerate(POSITIONS):
        ksp[b, p + 1:] = vsp[b, p + 1:] = float("nan")
    out = launched("decode_attention_int8", lambda: tda.decode_gqa_attention(
        tq, kp, vp, pos, k_scale=ksp, v_scale=vsp))
    ref = tda.decode_gqa_attention_quant_ref(tq, kp, vp, ksp, vsp, pos)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)

    for int8 in (False, True):
        arrs = [kq, vq, ks, vs] if int8 else [k, v]
        pools, table = paginate(arrs, POSITIONS)
        pools = poison_unreferenced(pools, table, POSITIONS)
        tp = [torch.from_numpy(p).to(dev) for p in pools]
        if not int8:
            tp = [p.to(dtype) for p in tp]
        sc = dict(k_scale=tp[2], v_scale=tp[3]) if int8 else {}
        tt = torch.from_numpy(table).to(dev)
        name = tda.edition(int8, True)
        out = launched(name, lambda: tda.decode_gqa_attention_paged(
            tq, tp[0], tp[1], tt, pos, **sc))
        ref = tda.decode_gqa_attention_paged_ref(tq, tp[0], tp[1], tt, pos, **sc)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
        if not int8:
            k1 = tda.decode_gqa_attention(tq, torch.from_numpy(k).to(dev, dtype),
                                          torch.from_numpy(v).to(dev, dtype), pos)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, k1, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_split_edges(dtype, atol):
    """Positions on the first row, and on the last and first rows of a
    64-row split: tiles of one live row, of 64, and the combine of 1–3
    tiles."""
    needs_card()
    check_editions(dtype, atol, [0, 63, 64, 127, 128, 255], S=256, H=32, Hkv=8, D=128)


@pytest.mark.cuda
def test_cuda_long_cache():
    """S = 8192: up to 128 tiles merged by one block's combine."""
    needs_card()
    # bf16: two bf16 ulps at magnitude 1 (the f32 sums are order-only).
    check_editions(torch.bfloat16, 1.6e-2, [8191, 4097, 64, 8000], S=8192, H=8, Hkv=2,
                   D=128, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("G,D", [(1, 128), (8, 128), (1, 64), (8, 64)])
def test_cuda_group_sizes(dtype, atol, G, D):
    """G = 1 and G = 8 query heads per KV head; f32 at D = 128 takes the
    dynamic shared-memory path (64 KB of K and V rows per block)."""
    needs_card()
    check_editions(dtype, atol, [5, 64, 200, 255], S=256, H=2 * G, Hkv=2, D=D, seed=G)


@pytest.mark.cuda
@pytest.mark.parametrize("page_s", [16, 128])
def test_cuda_page_sizes(page_s):
    """Pages shorter than a tile (one block each) and longer (two tiles of
    64 rows each), in f32 at D = 128."""
    needs_card()
    # f32: summation order only.
    check_editions(torch.float32, 1e-4, [0, 15, 16, 127, 128, 255], S=256, H=8, Hkv=2,
                   D=128, page_s=page_s)


@pytest.mark.cuda
def test_cuda_batch_changes_between_calls():
    """B = 8, then 3, then 8 again: the combine counters are back at 0
    after every call, so each call matches its plain version."""
    needs_card()
    rng = np.random.default_rng(11)
    for i, B in enumerate((8, 3, 8)):
        positions = [int(p) for p in rng.integers(0, 256, B)]
        # bf16: two bf16 ulps at magnitude 1.
        check_editions(torch.bfloat16, 1.6e-2, positions, S=256, H=32, Hkv=8, D=128,
                       seed=20 + i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_one_slot_views(dtype, atol):
    """The single-token extend piece's call: B = 1 on one slot of an
    8-slot engine cache, as a view (``c[:, s:s+1]`` of [L, B, S, Hkv, D],
    one layer of it), or through the one-row table slice ``table[s:s+1]``.
    Every other slot, its pages, the free pages and the trash page are
    poisoned; positions on the view's first, a middle and its last row.
    Each edition matches its plain version on the same view, and the
    paged ones equal the contiguous ones bit for bit."""
    needs_card()
    dev, B, S, H, Hkv, D = "cuda", 8, 256, 32, 8, 128
    q8, k, v = inputs(B=B, S=S, H=H, Hkv=Hkv, D=D, seed=30)
    kq, vq, ks, vs = quant(k, v)
    for s in (0, 5, 7):
        for p in (0, 100, S - 1):
            others = np.arange(B) != s
            past = np.zeros((B, S), bool)
            past[others] = True
            past[s, p + 1:] = True
            poisoned = []
            for a, bad in ((k, np.nan), (v, np.nan), (kq, 127), (vq, -127), (ks, np.nan),
                           (vs, np.nan)):
                a = a.copy()
                a[past] = bad
                # A leading layer axis, as the engine's [L, B, S, ...] cache.
                poisoned.append(np.stack([a, a]))
            ck, cv, ckq, cvq, cks, cvs = poisoned
            tq = torch.from_numpy(q8[s:s + 1]).to(dev, dtype)
            pos = torch.tensor([p], dtype=torch.int32, device=dev)

            def view(a, cast=True):
                t = torch.from_numpy(a).to(dev)
                t = t.to(dtype) if cast else t
                return t[:, s:s + 1][1]               # layer 1 of the slot view

            outs = {}
            kv = (view(ck), view(cv))
            kv8 = (view(ckq, False), view(cvq, False), view(cks, False), view(cvs, False))
            assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in kv + kv8[:2])
            outs["decode_attention"] = (
                tda.decode_gqa_attention(tq, *kv, pos),
                tda.decode_gqa_attention_ref(tq, *kv, pos))
            outs["decode_attention_int8"] = (
                tda.decode_gqa_attention(tq, kv8[0], kv8[1], pos, k_scale=kv8[2],
                                         v_scale=kv8[3]),
                tda.decode_gqa_attention_quant_ref(tq, *kv8, pos))
            positions = [S - 1] * B
            positions[s] = p
            for int8 in (False, True):
                arrs = [kq, vq, ks, vs] if int8 else [k, v]
                pools, table = paginate(arrs, positions)
                pools = poison_unreferenced(pools, table, positions)
                for pool in pools:
                    bad = 127 if pool.dtype == np.int8 else np.nan
                    for b in np.flatnonzero(others):
                        pool[table[b]] = bad          # the other slots' pages
                tp = [torch.from_numpy(x).to(dev) for x in pools]
                if not int8:
                    tp = [x.to(dtype) for x in tp]
                sc = dict(k_scale=tp[2], v_scale=tp[3]) if int8 else {}
                row = torch.from_numpy(table).to(dev)[s:s + 1]
                outs[tda.edition(int8, True)] = (
                    tda.decode_gqa_attention_paged(tq, tp[0], tp[1], row, pos, **sc),
                    tda.decode_gqa_attention_paged_ref(tq, tp[0], tp[1], row, pos, **sc))
            torch.cuda.synchronize()
            for name, (out, ref) in outs.items():
                assert torch.isfinite(out).all(), f"{name} s={s} p={p}: a poisoned row was read"
                torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0,
                                           msg=lambda m: f"{name} s={s} p={p}: {m}")
            for paged, contiguous in (("decode_attention_paged", "decode_attention"),
                                      ("decode_attention_paged_int8", "decode_attention_int8")):
                torch.testing.assert_close(outs[paged][0], outs[contiguous][0], atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_misaligned_rows_raise():
    """Rows are copied 16 bytes at a time: a view that starts off a 16-byte
    boundary raises and launches nothing."""
    needs_card()
    q, k, v = inputs(B=2, S=128, H=8, Hkv=2, D=64)
    kq, vq, ks, vs = quant(k, v)
    dev = "cuda"
    pos = torch.tensor([3, 127], dtype=torch.int32, device=dev)
    tq = torch.from_numpy(q).to(dev, torch.bfloat16)
    flat = torch.zeros(kq.size + 16, dtype=torch.int8, device=dev)
    k_bad = flat[1:1 + kq.size].view(kq.shape)
    k_bad.copy_(torch.from_numpy(kq))
    assert k_bad.is_contiguous() and k_bad.data_ptr() % 16
    vp, ksp, vsp = (torch.from_numpy(a).to(dev) for a in (vq, ks, vs))
    before = dict(tda.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        tda.decode_gqa_attention(tq, k_bad, vp, pos, k_scale=ksp, v_scale=vsp)
    flat16 = torch.zeros(k.size + 8, dtype=torch.bfloat16, device=dev)
    k16 = flat16[1:1 + k.size].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        tda.decode_gqa_attention(tq, k16, torch.from_numpy(v).to(dev, torch.bfloat16), pos)
    assert tda.LAUNCHES == before


def _qdot_case(mode, dtype, rows, K=256, N=96):
    rng = np.random.default_rng(rows)
    h = torch.from_numpy(rng.standard_normal((rows, K)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    qw = tquant.quantize_weight(w, mode)
    card = tquant.qdot(h.cuda(), {k: v.cuda() for k, v in qw.items()})
    torch.cuda.synchronize()
    return card.cpu(), tquant.qdot(h, qw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 17])
@pytest.mark.parametrize("K", [64, 256])
def test_cuda_w8a8_qdot_equals_cpu_route(dtype, rows, K):
    """W8A8 on the card (torch._int_mm on the column-major weight, rows
    padded up to its 17-row minimum) equals the CPU route bit for bit: the
    int32 sums are exact, the scales true quotients, the rescale
    elementwise. K = 64 is test-tiny's width."""
    needs_card()
    card, cpu = _qdot_case("int8-dynamic", dtype, rows, K=K)
    assert card.dtype == dtype and torch.equal(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_w8a16_qdot_matches_cpu_route(dtype):
    """W8A16 on the card keeps the product in f32 (torch.mm with
    out_dtype) like the CPU route: f32 summation order only, then one
    rounding to the activation dtype (one bf16 step, 2^-7 relative)."""
    needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = _qdot_case("int8", dtype, 8)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(card.float(), cpu.float(), rtol=rtol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kv_row_scales_equal_cpu_route(dtype):
    """int8 KV rows quantized on the card equal the CPU route bit for
    bit, scales included: the scale divides by a device tensor, which
    CUDA does not turn into a reciprocal multiply. Rows of llama3-8b's
    KV width, magnitudes across many binades."""
    needs_card()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 257, 8, 128)) * np.exp(rng.uniform(-6, 6, (4, 257, 8, 1)))
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    card = quantize_rows(x.cuda())
    torch.cuda.synchronize()
    cpu = quantize_rows(x)
    assert torch.equal(card.s.cpu(), cpu.s)
    assert torch.equal(card.q.cpu(), cpu.q)


def _watchdog_engine(**fields):
    from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
    from omnia_tpu_torch.models import get_config

    return InferenceEngine(get_config("test-tiny"),
                           EngineConfig(num_slots=2, max_seq=64, prefill_buckets=(8,),
                                        dtype="float32", watchdog_s=0.2, **fields),
                           device="cuda")


# About 1.5 s of the card's clock: a stream stuck for far longer than
# the 0.2 s watchdog.
WEDGE_CYCLES = 3_000_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [dict(), dict(kv_quant="int8", kv_pages=9,
                                                 kv_page_tokens=16)])
def test_cuda_recovery_waits_for_a_wedged_stream(fields):
    """A watchdog trip on a stream that is really stuck: the recovery's
    reallocation waits for the stream (its pageable copies do), the
    engine stays unhealthy meanwhile, and health returns only once the
    stream has run the reallocation."""
    import threading
    import time

    needs_card()
    eng = _watchdog_engine(**fields)
    torch.cuda.synchronize()
    eng._healthy = False                  # as the trip leaves it
    torch.cuda._sleep(WEDGE_CYCLES)
    t0 = time.monotonic()
    th = threading.Thread(target=eng._recover, args=("wedged",))
    th.start()
    time.sleep(0.5)
    assert not eng.healthy() and th.is_alive()
    th.join(timeout=30)
    assert not th.is_alive()
    assert eng.healthy() and eng.metrics["recoveries"] == 1
    assert time.monotonic() - t0 > 0.5


@pytest.mark.cuda
def test_cuda_recovery_check_bounds_its_wait():
    """The check behind health after a recovery: an event recorded behind
    work that outlasts watchdog_s reads as not run, after watchdog_s."""
    import time

    needs_card()
    eng = _watchdog_engine()
    torch.cuda.synchronize()
    torch.cuda._sleep(WEDGE_CYCLES)
    t0 = time.monotonic()
    assert eng._stream_ran_recovery() is False
    assert 0.2 <= time.monotonic() - t0 < 1.0
    torch.cuda.synchronize()
    assert eng._stream_ran_recovery() is True


# ---------------------------------------------------------------------------
# The captured ring chunk (engine/graphs.py)
# ---------------------------------------------------------------------------

RING_CACHES = {
    "K1": dict(),
    "K2": dict(kv_quant="int8"),
    "K3": dict(kv_pages=33, kv_page_tokens=16),
    "K4": dict(kv_quant="int8", kv_pages=33, kv_page_tokens=16),
}


def _ring_engine(ring=2, variants=(2, 4), **fields):
    from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
    from omnia_tpu_torch.models import get_config

    return InferenceEngine(get_config("test-tiny"),
                           EngineConfig(num_slots=4, max_seq=128, prefill_buckets=(16, 32),
                                        dtype="float32", decode_chunk=8,
                                        decode_chunk_variants=variants, decode_ring=ring,
                                        **fields),
                           seed=0, device="cuda")


def _clone_kv(c):
    from omnia_tpu_torch.models.kv_quant import kv_map
    from omnia_tpu_torch.models.paged_kv import PagedKV, is_paged

    if is_paged(c):
        return PagedKV(kv_map(lambda a: a.clone(), c.pool), c.table.clone())
    return kv_map(lambda a: a.clone(), c)


def _kv_leaves(c) -> list:
    from omnia_tpu_torch.models.paged_kv import is_paged

    c = c.pool if is_paged(c) else c
    return [c.q, c.s] if hasattr(c, "q") else [c]


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["K1", "K4"])
def test_cuda_captured_ring_chunk_equals_eager(cache):
    """Each chunk size's captured ring chunk against the eager ring chunk
    (the CPU's edition, branching on the host) run on the card from a
    copy of the same state: the same tokens, state, deadline carry and KV
    caches, bit for bit, and the same decode-attention launches (the
    replay's counted on the card), so a chunk stops running steps once
    every slot is done. Between two chunks a decode-attention call at a
    larger shape grows the kernels' scratch: the graphs keep the buffer
    they captured."""
    from omnia_tpu_torch.engine import SamplingParams
    from omnia_tpu_torch.engine.graphs import NO_DEADLINE

    needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = _ring_engine(**RING_CACHES[cache])
    assert eng._ring_graphs is None                # captured where first needed
    assert sorted(eng._ring()._graphs) == [1, 2, 4, 8]
    edition, layers = eng._kernel_edition(), eng.model_cfg.num_layers
    reqs = [([1, 2, 3], dict(temperature=0.0, max_tokens=3)),
            ([4, 5, 6, 7, 8], dict(temperature=0.0, max_tokens=30)),
            ([9] * 20, dict(temperature=0.8, top_p=0.9, top_k=40, seed=3, max_tokens=14)),
            ([11, 12], dict(temperature=0.0, max_tokens=20, stop_token_ids=(17, 200)))]
    for prompt, kw in reqs:
        eng.submit(prompt, SamplingParams(**kw))
    while True:
        pending, slot = eng._claim_pending()
        if pending is None:
            break
        eng._place_pending(slot, *pending)
    dl = np.full(4, NO_DEADLINE, np.int32)
    dl[1] = 2                                      # masked after two steps
    ran_total = 0
    for n, k in enumerate((8, 4, 2, 1, 8, 8)):
        eng._prealloc_decode_pages(k)
        fixed = (eng._tokens, eng._positions, eng._active, eng._budget, eng._key_data)
        state = [t.clone() for t in fixed]
        ck, cv = _clone_kv(eng._ck), _clone_kv(eng._cv)
        tda.reset_launches()
        eager = eng._decode_fns[k](eng.params, ck, cv, *state[:4], eng._stop_ids, state[4],
                                   eng._temp, eng._top_p, eng._top_k,
                                   torch.from_numpy(dl).cuda())
        eager_launches = tda.launches()
        tda.reset_launches()
        toks = eng._ring_graphs.replay(k, dl)
        assert tda.launches() == eager_launches, (cache, k)
        assert torch.equal(toks, eager[-1]), (cache, k)
        for got, want in zip(fixed, eager[2:7]):
            assert torch.equal(got, want), (cache, k)
        assert torch.equal(eng._ring_graphs.dl, eager[7])
        for got, want in zip(_kv_leaves(eng._ck) + _kv_leaves(eng._cv),
                             _kv_leaves(ck) + _kv_leaves(cv)):
            assert torch.equal(got, want), (cache, k)
        steps = eager_launches[edition] // layers
        assert eager_launches[edition] == layers * steps
        assert steps == k or not eng._active.any()
        ran_total += steps
        dl = np.maximum(dl - k, 1)
        if n == 0:
            # Partials of a B-slot call at S = 8192, H = 32, D = 128: past
            # whatever the scratch holds now.
            grown = tda._SCRATCH[0][0].numel()
            B = 8 * (grown // (8 * 32 * 128 * 130) + 1)
            q = torch.randn(B, 32, 128, device="cuda", dtype=torch.bfloat16)
            kv = torch.randn(B, 8192, 8, 128, device="cuda", dtype=torch.bfloat16)
            tda.decode_gqa_attention(q, kv, kv, torch.full((B,), 8191, dtype=torch.int32,
                                                           device="cuda"))
            assert tda._SCRATCH[0][0].numel() > grown
            assert eng._ring_graphs._graphs[8][2].data_ptr() != tda._SCRATCH[0][0].data_ptr()
            del q, kv
    assert 0 < ran_total < 31 and not eng._active.any()   # the last chunk stopped early


@pytest.mark.cuda
@pytest.mark.parametrize("cache", list(RING_CACHES))
def test_cuda_ring_engine_serves_ring_off_tokens(cache):
    """A ring engine on the card (graphs replayed, reads drained on the
    drainer thread) gives the ring-off engine's greedy tokens and
    finishes; its kernel's launches, counted on the card, are num_layers
    x the steps that ran (decode steps less the early exits); construction
    captures nothing, a recovery captures the graphs again on the
    reallocated state, and the engine then serves the same tokens."""
    from omnia_tpu_torch.engine import SamplingParams

    needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = [[1, 2, 3], [7] * 30, [5, 4], list(range(40, 60)), [8, 9, 10, 11]]

    def serve(eng):
        hs = [eng.submit(p, SamplingParams(temperature=0.0, max_tokens=5 + 4 * i))
              for i, p in enumerate(prompts)]
        while eng.step():
            pass
        torch.cuda.synchronize()
        return [(lambda t, f: (t, f.finish_reason.value))(*h.collect_tokens(timeout=60))
                for h in hs]

    # Chunks of 8 and 1 only, so that tails overshoot and chunks exit early.
    off = _ring_engine(ring=0, variants=(), **RING_CACHES[cache])
    on = _ring_engine(ring=2, variants=(), **RING_CACHES[cache])
    assert on._ring_graphs is None
    # Captured here, not at the first dispatch: the eager step before the
    # first capture launches the kernel once per layer.
    on._ring()
    want = serve(off)
    edition = on._kernel_edition()
    m0 = dict(on.metrics)
    tda.reset_launches()
    assert serve(on) == want
    steps = ((on.metrics["decode_steps"] - m0["decode_steps"])
             - (on.metrics["early_exit_steps"] - m0["early_exit_steps"]))
    launches = tda.launches()
    assert launches[edition] == on.model_cfg.num_layers * steps
    assert sum(launches.values()) == launches[edition]
    assert on.metrics["ring_drains"] > 0 and on.metrics["early_exit_steps"] > 0
    graphs = on._ring_graphs
    on._recover("test")
    assert on.healthy() and on._ring_graphs is not None and on._ring_graphs is not graphs
    assert serve(on) == want
    on.stop()
    off.stop()


@pytest.mark.cuda
def test_cuda_kernel_refuses_inputs_that_need_a_gradient():
    """The decode kernel has no backward: a T == 1 forward_train on the card
    over params that require grad raises rather than cut the gradient.
    Under no_grad the same forward launches the kernel once per layer and
    gives the CPU's plain-route logits."""
    from omnia_tpu_torch.models import get_config, llama

    needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("test-tiny")
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)

    def tree(t, fn):
        return {k: tree(v, fn) for k, v in t.items()} if isinstance(t, dict) else fn(t)

    card = tree(cpu, lambda t: t.cuda().requires_grad_(True))
    tokens = torch.tensor([[5], [9]], dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        llama.forward_train(card, cfg, tokens.cuda())
    before = tda.LAUNCHES["decode_attention"]
    with torch.no_grad():
        out = llama.forward_train(card, cfg, tokens.cuda())
    torch.cuda.synchronize()
    assert tda.LAUNCHES["decode_attention"] == before + cfg.num_layers
    torch.testing.assert_close(out.cpu(), llama.forward_train(cpu, cfg, tokens),
                               atol=1e-5, rtol=0)

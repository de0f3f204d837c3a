"""Decode-attention kernels (K1–K4) against their plain versions, on a
card. This file imports neither jax nor omnia_tpu (the machine with the
card has neither), so run it there without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Here, on a host without a card, every test skips. The helpers build the
inputs that test_torch_decode_attention.py also feeds the JAX kernels."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from omnia_tpu_torch.models.kv_quant import quantize_rows_np
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


def paginate(arrs, positions, free_pages=3, seed=7):
    """Scatter contiguous [B, S, ...] arrays into a scrambled page pool
    (the layout of tests/test_decode_attention.py::_paginate): pool page
    0 is the trash page and pages 1..free_pages-1 stay free; table
    entries past each position's page point at trash."""
    B, S = arrs[0].shape[:2]
    npg = S // PAGE_S
    perm = np.random.RandomState(seed).permutation(B * npg) + free_pages
    pools = [np.zeros((B * npg + free_pages, PAGE_S) + a.shape[2:], a.dtype)
             for a in arrs]
    table = np.zeros((B, npg), np.int32)
    for b in range(B):
        for j in range(positions[b] // PAGE_S + 1):
            pid = int(perm[b * npg + j])
            for pool, a in zip(pools, arrs):
                pool[pid] = a[b, j * PAGE_S:(j + 1) * PAGE_S]
            table[b, j] = pid
    return pools, table


def poison_unreferenced(pools, table, positions, nan_int8=127):
    """NaN (or a huge int8) in every pool page the table does not
    reference for a live row (free pages and the trash page) and in the
    referenced rows past each position."""
    live = {int(table[b, j]) for b, p in enumerate(positions) for j in range(p // PAGE_S + 1)}
    out = []
    for pool in pools:
        bad = nan_int8 if pool.dtype == np.int8 else np.nan
        pool = pool.copy()
        for pid in range(pool.shape[0]):
            if pid not in live:
                pool[pid] = bad
        for b, p in enumerate(positions):
            pool[table[b, p // PAGE_S], p % PAGE_S + 1:] = bad
        out.append(pool)
    return out


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

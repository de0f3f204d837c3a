"""Decode attention (K1–K4): the port's plain versions against the JAX
Pallas kernels run in interpret mode on the CPU, and the CPU route of
the wrappers. The CUDA kernels are held against these plain versions in
test_torch_kernels_cuda.py, on a card."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.ops.decode_attention import decode_gqa_attention as jax_decode
from omnia_tpu.ops.decode_attention import decode_gqa_attention_paged as jax_paged
from omnia_tpu_torch.ops import decode_attention as tda
from test_torch_kernels_cuda import POSITIONS
from test_torch_kernels_cuda import inputs as _inputs
from test_torch_kernels_cuda import paginate as _paginate
from test_torch_kernels_cuda import poison_unreferenced as _poison_unreferenced
from test_torch_kernels_cuda import quant as _quant

BF16_NP = jnp.bfloat16  # numpy-compatible bf16 dtype (ml_dtypes) for JAX inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_pallas_interpret(dtype):
    q, k, v = _inputs()
    pos = np.array(POSITIONS, np.int32)
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a, BF16_NP) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                      for a in (jq, jk, jv))
        # bf16 output: two bf16 ulps at magnitude ~1 plus rounding-order slack.
        atol = 2e-2
    else:
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        atol = 1e-5  # f32, summation order only
    ref = jax_decode(jq, jk, jv, jnp.asarray(pos), block_s=128, interpret=True)
    out = tda.decode_gqa_attention_ref(tq, tk, tv, torch.from_numpy(pos))
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


def test_nan_rows_past_position_do_not_influence():
    q, k, v = _inputs(seed=1)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    clean = tda.decode_gqa_attention(tq, tk, tv, pos)
    kp, vp = tk.clone(), tv.clone()
    for b, p in enumerate(POSITIONS):
        kp[b, p + 1:] = float("nan")
        vp[b, p + 1:] = float("nan")
    poisoned = tda.decode_gqa_attention(tq, kp, vp, pos)
    assert torch.isfinite(poisoned).all()
    torch.testing.assert_close(poisoned, clean, atol=0, rtol=0)


def test_wrapper_rejects_unsupported_shapes():
    q, k, v = map(torch.from_numpy, _inputs(D=64))
    pos = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        tda.decode_gqa_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                 v[..., :32].contiguous(), pos)
    with pytest.raises(ValueError, match="int32"):
        tda.decode_gqa_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match="dtypes"):
        tda.decode_gqa_attention(q.double(), k.double(), v.double(), pos)


# -- K2: int8 rows with f32 row scales ---------------------------------------

def _q_pair(q, dtype):
    """The same q for JAX and the port, in f32 or bf16."""
    if dtype == "bfloat16":
        jq = jnp.asarray(q, BF16_NP)
        return jq, torch.from_numpy(np.asarray(jq, np.float32)).to(torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def test_scratch_buffer_layout_and_growth():
    """The kernels' scratch: the combine counters at the head of one buffer
    per device, the partials 256 bytes aligned after a counter room that
    only grows, so a call with fewer slots never lays partials over a
    counter; the buffer is zeroed when made, grows when either part
    outgrows it, and never shrinks."""
    dev = torch.device("cpu")
    tda._SCRATCH.pop(dev.index, None)
    try:
        c0, p0 = tda._scratch(dev, 5, 100)
        buf, cap = tda._SCRATCH[dev.index]
        assert (cap, c0, p0 - c0) == (64, buf.data_ptr(), 4 * 64)
        assert buf.numel() == 64 + 100 and not buf.any()
        assert tda._scratch(dev, 3, 50) == (c0, p0)            # fits: same buffer
        c1, p1 = tda._scratch(dev, 70, 100)                     # more counters
        buf, cap = tda._SCRATCH[dev.index]
        assert (cap, p1 - c1, buf.numel()) == (128, 4 * 128, 128 + 100)
        assert not buf.any()
        c2, p2 = tda._scratch(dev, 1, 1000)                     # more partials
        buf, cap = tda._SCRATCH[dev.index]
        assert (cap, p2 - c2, buf.numel()) == (128, 4 * 128, 128 + 1000)
        assert tda._scratch(dev, 70, 10) == (c2, p2)            # never shrinks
    finally:
        tda._SCRATCH.pop(dev.index, None)


def test_launch_counts_reset_and_sum():
    """``launches()`` is the wrappers' counts plus each card's graph
    counts (none without a card), one entry per edition; a CPU call runs
    the plain version and counts nothing; ``reset_launches()`` zeroes
    every count."""
    tda.reset_launches()
    assert tda.launches() == dict.fromkeys(tda.EDITIONS, 0)
    q, k, v = (torch.from_numpy(a) for a in _inputs(B=2, S=64, H=4, Hkv=2, D=16))
    tda.decode_gqa_attention(q, k, v, torch.tensor([3, 63], dtype=torch.int32))
    assert tda.launches() == dict.fromkeys(tda.EDITIONS, 0)
    tda.LAUNCHES["decode_attention_paged"] += 3
    assert tda.launches()["decode_attention_paged"] == 3
    tda.reset_launches()
    assert set(tda.LAUNCHES.values()) == {0}


# f32: summation order only; bf16 output: two bf16 ulps at magnitude ~1.
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_ref_matches_jax_pallas_interpret(dtype):
    q, k, v = _inputs(seed=2)
    kq, vq, ks, vs = _quant(k, v)
    pos = np.array(POSITIONS, np.int32)
    jq, tq = _q_pair(q, dtype)
    ref = jax_decode(jq, jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(pos),
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                     block_s=128, interpret=True)
    args = [torch.from_numpy(a) for a in (kq, vq, ks, vs, pos)]
    out = tda.decode_gqa_attention_quant_ref(tq, *args)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=ATOL[dtype], rtol=0)
    # The CPU route of the wrapper is the plain version.
    kq_t, vq_t, ks_t, vs_t, pos_t = args
    routed = tda.decode_gqa_attention(tq, kq_t, vq_t, pos_t, k_scale=ks_t, v_scale=vs_t)
    torch.testing.assert_close(routed, out, atol=0, rtol=0)


def test_quant_nan_past_position_do_not_influence():
    q, k, v = _inputs(seed=3)
    kq, vq, ks, vs = (torch.from_numpy(a) for a in _quant(k, v))
    tq, pos = torch.from_numpy(q), torch.tensor(POSITIONS, dtype=torch.int32)
    clean = tda.decode_gqa_attention(tq, kq, vq, pos, k_scale=ks, v_scale=vs)
    kp, vp, ksp, vsp = kq.clone(), vq.clone(), ks.clone(), vs.clone()
    for b, p in enumerate(POSITIONS):
        kp[b, p + 1:], vp[b, p + 1:] = 127, -127
        ksp[b, p + 1:] = vsp[b, p + 1:] = float("nan")
    poisoned = tda.decode_gqa_attention(tq, kp, vp, pos, k_scale=ksp, v_scale=vsp)
    assert torch.isfinite(poisoned).all()
    torch.testing.assert_close(poisoned, clean, atol=0, rtol=0)


# -- K3 / K4: a page pool behind a page table ---------------------------------

def _paged_case(seed, quant):
    q, k, v = _inputs(seed=seed)
    arrs = list(_quant(k, v)) if quant else [k, v]
    pools, table = _paginate(arrs, POSITIONS)
    return q, pools, table


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_matches_jax_pallas_interpret(dtype, quant):
    q, pools, table = _paged_case(4, quant)
    pos = np.array(POSITIONS, np.int32)
    jq, tq = _q_pair(q, dtype)
    if not quant and dtype == "bfloat16":
        pools = [np.asarray(jnp.asarray(p, BF16_NP), np.float32) for p in pools]
    jpools = [jnp.asarray(p, BF16_NP) if (dtype == "bfloat16" and not quant)
              else jnp.asarray(p) for p in pools]
    scales = dict(k_scale=jpools[2], v_scale=jpools[3]) if quant else {}
    ref = jax_paged(jq, jpools[0], jpools[1], jnp.asarray(table), jnp.asarray(pos),
                    interpret=True, **scales)
    tpools = [torch.from_numpy(p) for p in pools]
    if not quant:
        tpools = [p.to(tq.dtype) for p in tpools]
    tscales = dict(k_scale=tpools[2], v_scale=tpools[3]) if quant else {}
    out = tda.decode_gqa_attention_paged_ref(tq, tpools[0], tpools[1],
                                             torch.from_numpy(table),
                                             torch.from_numpy(pos), **tscales)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K4"])
def test_paged_free_and_trash_pages_do_not_influence(quant):
    q, pools, table = _paged_case(5, quant)
    tq, pos = torch.from_numpy(q), torch.tensor(POSITIONS, dtype=torch.int32)
    ttable = torch.from_numpy(table)

    def run(pools):
        t = [torch.from_numpy(p) for p in pools]
        sc = dict(k_scale=t[2], v_scale=t[3]) if quant else {}
        return tda.decode_gqa_attention_paged(tq, t[0], t[1], ttable, pos, **sc)

    clean = run(pools)
    poisoned = run(_poison_unreferenced(pools, table, POSITIONS))
    assert torch.isfinite(poisoned).all()
    torch.testing.assert_close(poisoned, clean, atol=0, rtol=0)
    # Paged equals contiguous over the same rows.
    k, v = (torch.from_numpy(a) for a in _inputs(seed=5)[1:])
    if quant:
        kq, vq, ks, vs = (torch.from_numpy(a) for a in _quant(k.numpy(), v.numpy()))
        contiguous = tda.decode_gqa_attention(tq, kq, vq, pos, k_scale=ks, v_scale=vs)
    else:
        contiguous = tda.decode_gqa_attention(tq, k, v, pos)
    torch.testing.assert_close(clean, contiguous, atol=1e-6, rtol=0)


def test_paged_wrapper_rejects_bad_tables_and_scales():
    q, pools, table = _paged_case(6, True)
    tq, pos = torch.from_numpy(q), torch.tensor(POSITIONS, dtype=torch.int32)
    kq, vq, ks, vs = (torch.from_numpy(p) for p in pools)
    with pytest.raises(ValueError, match="table"):
        tda.decode_gqa_attention_paged(tq, kq, vq, torch.from_numpy(table).long(), pos,
                                       k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="both"):
        tda.decode_gqa_attention_paged(tq, kq, vq, torch.from_numpy(table), pos, k_scale=ks)
    with pytest.raises(ValueError, match="k_scale"):
        tda.decode_gqa_attention_paged(tq, kq, vq, torch.from_numpy(table), pos,
                                       k_scale=ks[:, :8].contiguous(), v_scale=vs)
    with pytest.raises(ValueError, match="dtypes"):
        tda.decode_gqa_attention_paged(tq, kq.float(), vq.float(), torch.from_numpy(table),
                                       pos, k_scale=ks, v_scale=vs)

"""int8 KV cache: the port's ``models/kv_quant.py`` held against the JAX
package's on the CPU. Quantization is bit-identical (tolerance 0): the
same ops in the same order, round half to even."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.models import kv_quant as jkvq
from omnia_tpu_torch.models import kv_quant as tkvq


def _rows(seed=0):
    """[4, 3, 2, 16] rows: random, an all-zero row, and a row whose
    absmax is 127 (scale exactly 1) holding exact ±0.5 ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 3, 2, 16)) * 3).astype(np.float32)
    x[1, 2, 0] = 0.0
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -127.0,
                     3.5, -4.5, 0.0, 7.0, 8.5, -9.5, 10.25, 11.75], np.float32)
    x[2, 1, 1] = ties
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical_to_jax(dtype):
    x = _rows()
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
        x = np.asarray(jx, np.float32)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ref = jkvq.quantize_rows(jx)
    ref_np = jkvq.quantize_rows_np(x)
    out = tkvq.quantize_rows(tx)
    out_np = tkvq.quantize_rows_np(x)
    assert out.q.dtype == torch.int8 and out.s.dtype == torch.float32
    for got_q, got_s in ((out.q.numpy(), out.s.numpy()), (out_np.q, out_np.s)):
        np.testing.assert_array_equal(got_q, np.asarray(ref.q))
        np.testing.assert_array_equal(got_s, np.asarray(ref.s))
        np.testing.assert_array_equal(got_q, ref_np.q)
    # The all-zero row quantizes to zeros with the floor scale, not NaN.
    assert not out.q[1, 2, 0].any() and out.s[1, 2, 0] == np.float32(1e-8 / 127)
    if dtype == "float32":
        # Ties round half to even at scale 1.
        np.testing.assert_array_equal(
            out.q[2, 1, 1].numpy()[:10], [0, 0, 2, -2, 2, -2, 126, -127, 4, -4])


def test_dequantize_matches_jax():
    x = _rows(1)
    jq = jkvq.quantize_rows(jnp.asarray(x))
    tq = tkvq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tkvq.dequantize_rows(tq).numpy(),
                                  np.asarray(jkvq.dequantize_rows(jq)))
    np.testing.assert_array_equal(tkvq.dequantize_rows_np(tq),
                                  jkvq.dequantize_rows_np(jq))


@pytest.mark.parametrize("start", [0, 5, 10])   # 10: clamped so the chunk fits
def test_cache_put_matches_jax(start):
    rng = np.random.default_rng(2)
    L, B, S, H, D, T = 2, 3, 16, 2, 16, 8
    chunk = rng.standard_normal((L, 1, T, H, D)).astype(np.float32)
    jcache = jkvq.QuantKV(jnp.zeros((L, B, S, H, D), jnp.int8),
                          jnp.zeros((L, B, S, H), jnp.float32))
    ref = jkvq.cache_put(jcache, jnp.asarray(chunk), (0, 1, start))
    tcache = tkvq.QuantKV(torch.zeros((L, B, S, H, D), dtype=torch.int8),
                          torch.zeros((L, B, S, H), dtype=torch.float32))
    out = tkvq.cache_put(tcache, torch.from_numpy(chunk), (0, 1, start))
    assert out is tcache  # in place
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.s.numpy(), np.asarray(ref.s))
    # A plain cache takes the float rows as they are.
    plain = tkvq.cache_put(torch.zeros((L, B, S, H, D)), torch.from_numpy(chunk),
                           (0, 1, start))
    jplain = jkvq.cache_put(jnp.zeros((L, B, S, H, D)), jnp.asarray(chunk), (0, 1, start))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jplain))
    with pytest.raises(TypeError):
        tkvq.cache_put(torch.zeros((L, B, S, H, D)), tkvq.quantize_rows(
            torch.from_numpy(chunk)), (0, 1, start))


def test_bytes_count_scales():
    q = tkvq.QuantKV(torch.zeros((2, 4, 8, 16), dtype=torch.int8),
                     torch.zeros((2, 4, 8), dtype=torch.float32))
    assert q.shape == (2, 4, 8, 16) and q.ndim == 4
    assert q.nbytes == 2 * 4 * 8 * 16 + 2 * 4 * 8 * 4
    assert tkvq.cache_bytes(q, None, torch.zeros(3)) == q.nbytes + 12
    assert tkvq.validate_kv_quant(None) is None
    assert tkvq.validate_kv_quant("int8") == "int8"
    with pytest.raises(ValueError, match="unknown kv_quant"):
        tkvq.validate_kv_quant("int4")

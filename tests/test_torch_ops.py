"""omnia_tpu_torch ops held against the JAX package's ops on the CPU.

Inputs are made from a seed with numpy and fed to both; tolerances are
stated per test (f32 throughout, so they cover only summation order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.ops import attention as jattn
from omnia_tpu.ops import norms as jnorms
from omnia_tpu.ops import rope as jrope
from omnia_tpu.ops import sampling as jsamp
from omnia_tpu_torch.ops import attention as tattn
from omnia_tpu_torch.ops import norms as tnorms
from omnia_tpu_torch.ops import rope as trope
from omnia_tpu_torch.ops import sampling as tsamp

LLAMA31_SCALING = (8.0, 1.0, 4.0, 8192)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_matches_jax():
    rng = _rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("scaling", [None, LLAMA31_SCALING])
def test_rope_matches_jax(scaling):
    rng = _rng(2)
    pos = rng.integers(0, 8000, size=(2, 7)).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 64, 500000.0, scaling)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 64, 500000.0, scaling)
    # Angles up to ~8000 rad: f32 cos/sin of equal angles agree to ~1 ulp
    # of the angle's magnitude in the argument reduction.
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)

    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                           torch.from_numpy(np.array(js))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("T", [1, 5])
def test_gqa_attention_matches_jax(T):
    rng = _rng(3)
    B, S, H, Hkv, D = 3, 32, 8, 2, 16
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    start = np.array([0, 9, S - T], np.int32)
    pos = (start[:, None] + np.arange(T)[None, :]).astype(np.int32)
    ref = np.asarray(jattn.gqa_attention(*map(jnp.asarray, (q, k, v, pos))))
    out = tattn.gqa_attention(*map(torch.from_numpy, (q, k, v, pos))).numpy()
    # f32, only the summation order differs.
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def _filter_case():
    """V=1024 logits: rows 0-2 take the 256-prefix fast path, row 3
    (nucleus over a flat tail) forces the full sort."""
    rng = _rng(4)
    V = 1024
    scaled = (rng.standard_normal((4, V)) * 3.0).astype(np.float32)
    scaled[3] = (rng.standard_normal(V) * 0.05).astype(np.float32)
    top_p = np.array([0.9, 1.0, 0.5, 0.995], np.float32)
    top_k = np.array([40, 7, 0, 0], np.int32)
    return scaled, top_p, top_k


@pytest.mark.parametrize("rows,expect_fast", [((0, 1, 2), True), ((0, 1, 2, 3), False)])
def test_filter_thresholds_match_jax(rows, expect_fast):
    scaled, top_p, top_k = _filter_case()
    scaled, top_p, top_k = scaled[list(rows)], top_p[list(rows)], top_k[list(rows)]
    assert jsamp.fast_path_feasible(scaled, top_p, top_k) is expect_fast
    ref = np.asarray(jsamp._filter_thresholds(
        jnp.asarray(scaled), jnp.asarray(top_p), jnp.asarray(top_k)))
    out = tsamp._filter_thresholds(
        torch.from_numpy(scaled), torch.from_numpy(top_p),
        torch.from_numpy(top_k)).numpy()
    # The admitted set must be identical; the threshold is one of the
    # logits, equal to within 1e-6.
    np.testing.assert_array_equal(scaled >= out, scaled >= ref)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_greedy_sampling_token_identical():
    rng = _rng(5)
    B, V = 6, 1024
    logits = rng.standard_normal((B, V)).astype(np.float32)
    logits[2, 17] = logits[2, 900] = 50.0   # a tie: first index wins in both
    temp = np.zeros(B, np.float32)
    top_p = np.full(B, 0.9, np.float32)
    top_k = np.full(B, 40, np.int32)
    jkeys = jnp.stack([jsamp.make_slot_key_data(i) for i in range(B)])
    jtok, _ = jsamp.sample_tokens_per_slot(
        jnp.asarray(logits), jkeys, jnp.asarray(temp), jnp.asarray(top_p),
        jnp.asarray(top_k))
    tkeys = torch.stack([tsamp.make_slot_key_data(i) for i in range(B)])
    ttok, new_keys = tsamp.sample_tokens_per_slot(
        torch.from_numpy(logits), tkeys, torch.from_numpy(temp),
        torch.from_numpy(top_p), torch.from_numpy(top_k))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ttok.numpy()[2] == 17
    assert new_keys[:, 1].tolist() == [1] * B


def test_sampled_stream_independent_of_batch_mates():
    """Port-only: a slot's sampled stream follows its seed alone."""
    rng = _rng(6)
    V = 512
    steps = [rng.standard_normal((3, V)).astype(np.float32) for _ in range(5)]

    def run(rows, seeds):
        keys = torch.stack([tsamp.make_slot_key_data(s) for s in seeds])
        n = len(rows)
        temp = torch.full((n,), 0.8)
        top_p = torch.full((n,), 0.95)
        top_k = torch.full((n,), 50, dtype=torch.int32)
        out = []
        for lg in steps:
            tok, keys = tsamp.sample_tokens_per_slot(
                torch.from_numpy(lg[list(rows)]), keys, temp, top_p, top_k)
            out.append(tok.tolist())
        return np.array(out)

    together = run((0, 1, 2), (11, 1234, 99))
    alone = run((1,), (1234,))
    swapped = run((2, 1), (5, 1234))
    np.testing.assert_array_equal(together[:, 1], alone[:, 0])
    np.testing.assert_array_equal(swapped[:, 1], alone[:, 0])
    assert len(set(alone[:, 0].tolist())) > 1


@pytest.mark.parametrize("seed,counter,hit", [(3, 13, 13382), (32, 12, 103475)])
def test_noise_finite_where_the_hash_tops_out(seed, counter, hit):
    """Port-only: at these sampler states vocab index ``hit`` draws the
    hash's top value, whose uniform rounded to 1.0 in f32 and gave +inf
    noise: a masked or filtered-out token then won. The noise is finite
    and the sample stays inside a mask and the top-k set at llama3's
    vocab."""
    V = 128256
    keys = torch.tensor([[seed, counter]], dtype=torch.int64)
    noise = tsamp.gumbel_noise(keys, V)
    assert torch.isfinite(noise).all() and noise[0, hit] > 15
    logits = torch.from_numpy(_rng(7).standard_normal((1, V)).astype(np.float32))
    bias = torch.full((1, V), tsamp._NEG_INF)
    bias[0, :3] = 0.0
    tok, _ = tsamp.sample_tokens_per_slot(logits, keys, torch.tensor([0.7]),
                                          torch.tensor([0.9]),
                                          torch.tensor([40], dtype=torch.int32), mask_bias=bias)
    assert int(tok[0]) < 3
    tok, _ = tsamp.sample_tokens_per_slot(logits, keys, torch.tensor([0.7]),
                                          torch.tensor([1.0]),
                                          torch.tensor([40], dtype=torch.int32))
    assert int(tok[0]) in torch.topk(logits[0], 40).indices.tolist()

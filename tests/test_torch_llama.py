"""The port's dense Llama held against the JAX model on the CPU: the same
``test-tiny`` f32 params (converted with ``params_from_jax``) and the
same tokens give logits within 1e-4 (f32; only summation order differs)
and the same KV caches, through a prefill and three decode steps."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import llama as tllama
from omnia_tpu_torch.models.convert import params_from_jax

ATOL = 1e-4


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _close(out: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("tie", [False, True])
def test_forward_matches_jax(tie):
    jcfg = dataclasses.replace(jget_config("test-tiny"), tie_embeddings=tie)
    tcfg = dataclasses.replace(get_config("test-tiny"), tie_embeddings=tie)
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    assert ("lm_head" in tparams) is (not tie)

    rng = np.random.default_rng(0)
    B, T, S = 2, 8, 32
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()

    jl, jk, jv = jllama.forward_prefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    tl, tk, tv = tllama.forward_prefill(tparams, tcfg, torch.from_numpy(tokens),
                                        torch.from_numpy(pos))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)

    jck, jcv = jllama.init_kv_cache(jcfg, B, S, dtype=jnp.float32)
    tck, tcv = tllama.init_kv_cache(tcfg, B, S, "cpu", dtype=torch.float32)
    start = np.zeros(B, np.int32)
    jl, jck, jcv = jllama.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos),
                                  jck, jcv, jnp.asarray(start))
    tl, tck, tcv = tllama.forward(tparams, tcfg, torch.from_numpy(tokens),
                                  torch.from_numpy(pos), tck, tcv,
                                  torch.from_numpy(start))
    _close(tl, jl)
    _close(tck, jck)
    _close(tcv, jcv)

    # Three decode steps at per-slot positions, fed JAX's greedy tokens.
    cur = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    positions = np.array([T, T], np.int32)
    for _ in range(3):
        jl, jck, jcv = jllama.forward(
            jparams, jcfg, jnp.asarray(cur[:, None]), jnp.asarray(positions[:, None]),
            jck, jcv, jnp.asarray(positions))
        tl, tck, tcv = tllama.forward(
            tparams, tcfg, torch.from_numpy(cur[:, None]),
            torch.from_numpy(positions[:, None]), tck, tcv,
            torch.from_numpy(positions))
        _close(tl, jl)
        _close(tck, jck)
        _close(tcv, jcv)
        cur = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(np.int32)
        positions = positions + 1


def test_params_from_jax_bf16_is_exact():
    cfg = jget_config("test-tiny")
    jparams = jllama.init_params(cfg, jax.random.key(1), dtype=jnp.bfloat16)
    tree = _np_tree(jparams)
    tparams = params_from_jax(tree, "cpu")
    wq_np = tree["layers"]["attn"]["wq"]
    wq = tparams["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.float().numpy(), wq_np.astype(np.float32))
    assert params_from_jax(tree, "cpu", torch.float32)["embed"].dtype == torch.float32


def test_unported_paths_raise():
    with pytest.raises(ValueError, match="unknown kv_quant"):
        tllama.init_kv_cache(get_config("test-tiny"), 1, 8, "cpu", kv_quant="int4")


def _leaves(c):
    """Arrays of a cache of either package: plain, QuantKV or PagedKV."""
    if hasattr(c, "table"):
        return _leaves(c.pool) + [np.asarray(c.table)]
    if hasattr(c, "s"):
        return [np.asarray(c.q), np.asarray(c.s)]
    return [np.asarray(c)]


@pytest.mark.parametrize("kv_quant,paged", [("int8", False), (None, True), ("int8", True)])
def test_forward_over_int8_and_paged_caches_matches_jax(kv_quant, paged):
    """A prefill then three decode steps through ``forward`` over the same
    cache layout in both packages: logits within 1e-4 and int8 rows
    within one step (a score off by f32 rounding may round across .5)."""
    from omnia_tpu.models.paged_kv import PagedKV as JPagedKV
    from omnia_tpu_torch.models.paged_kv import PagedKV

    jcfg, tcfg = jget_config("test-tiny"), get_config("test-tiny")
    jparams = jllama.init_params(jcfg, jax.random.key(2), dtype=jnp.float32)
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    B, T, S, PS = 2, 8, 32, 8
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if paged:
        # 10 pages: trash, then a scrambled page per table position.
        table = (np.random.default_rng(2).permutation(B * S // PS) + 1).reshape(B, -1)
        table = table.astype(np.int32)
        jck, jcv = jllama.init_kv_cache(jcfg, 1 + B * S // PS, PS, dtype=jnp.float32,
                                        kv_quant=kv_quant)
        tck, tcv = tllama.init_kv_cache(tcfg, 1 + B * S // PS, PS, "cpu",
                                        dtype=torch.float32, kv_quant=kv_quant)
        jck, jcv = JPagedKV(jck, jnp.asarray(table)), JPagedKV(jcv, jnp.asarray(table))
        tt = torch.from_numpy(table)
        tck, tcv = PagedKV(tck, tt), PagedKV(tcv, tt)
    else:
        jck, jcv = jllama.init_kv_cache(jcfg, B, S, dtype=jnp.float32, kv_quant=kv_quant)
        tck, tcv = tllama.init_kv_cache(tcfg, B, S, "cpu", dtype=torch.float32,
                                        kv_quant=kv_quant)

    def step(tok, p, start):
        nonlocal jck, jcv
        jl, jck, jcv = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(p),
                                      jck, jcv, jnp.asarray(start))
        tl, _, _ = tllama.forward(tparams, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(p), tck, tcv, torch.from_numpy(start))
        _close(tl, jl)
        for t, j in zip(_leaves(tck) + _leaves(tcv), _leaves(jck) + _leaves(jcv)):
            atol = 1 if t.dtype == np.int8 else ATOL
            np.testing.assert_allclose(t.astype(np.float32), j.astype(np.float32),
                                       atol=atol, rtol=1e-4)
        return np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)

    cur = step(tokens, pos, np.zeros(B, np.int32))
    positions = np.array([T, T + 3], np.int32)
    for _ in range(3):
        cur = step(cur[:, None], positions[:, None], positions)
        positions = positions + 1

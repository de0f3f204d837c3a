"""Sequence parallelism in the port against the JAX package, on the CPU:
the port's ranks are four spawned processes in one gloo group
(``parallel/launch.py``, rank functions in ``torch_dpsp_workers.py``),
JAX's mesh the 8 virtual CPU devices.

- ``ring_attention`` against JAX's ``ring_attention`` and the dense
  reference at the cases of
  ``tests/test_parallel_long_context.py::test_ring_attention_matches_dense``
  with sp <= 4, and at dp = 2 x sp = 2 (the batch over dp, the sequence
  over sp), rtol/atol 2e-4.
- ``forward_prefill_ring`` at sp = 2 x tp = 2 against JAX's on the same
  mesh (logits and KV rows, f32, 1e-4).
- The analogs of ``tests/test_engine_sessions.py::TestLongContextServing``
  at sp = 2 x tp = 2: a long prompt's ring prefill gives the dense
  engine's greedy tokens; a prompt below the threshold skips the ring
  (ring dispatches counted); a session's second turn reuses the first's
  rows and gives the dense engine's tokens. Warmup runs the ring bucket.
  On the int8 + paged cache the ring's chunk is quantized as it is
  written through the slot's pages, and gives the dense engine's tokens
  on that cache. At dp = 2 x sp = 2 each dp shard's ring prefills the
  long prompt its slot got, and both give the dense engine's tokens.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dpsp_workers as workers
from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.ops.attention import gqa_attention
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu.parallel import ring_attention as jring_attention
from omnia_tpu.parallel import shard_pytree as jshard_pytree
from omnia_tpu_torch.parallel.launch import spawn_ranks

RING_TOL = dict(rtol=2e-4, atol=2e-4)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
# (mesh of the port's four ranks, JAX's mesh, B, T, H, Hkv, D)
RING_CASES = {
    "sp4_h4_kv2": (dict(sp=4), dict(dp=1, tp=1, sp=4), 2, 64, 4, 2, 16),
    "sp2_h8_kv2": (dict(dp=2, sp=2), dict(dp=1, tp=1, sp=2), 2, 64, 8, 2, 16),
    "dp2_sp2": (dict(dp=2, sp=2), dict(dp=2, tp=1, sp=2), 4, 32, 2, 2, 8),
}
ENGINE_BASE = dict(num_slots=2, max_seq=64, prefill_buckets=(8, 32), dtype="float32",
                   long_prefill_threshold=16)
GREEDY = JSamplingParams(temperature=0.0, max_tokens=5)
K4 = dict(kv_quant="int8", kv_pages=16, kv_page_tokens=8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dense(q, k, v):
    B, T = q.shape[:2]
    return gqa_attention(q, k, v, jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return {"OMNIA_WARMUP_MANIFEST_DIR": str(tmp_path_factory.mktemp("manifests"))}


@pytest.fixture(scope="module")
def sp_run(env, devices8):
    """Both sides of every check (one spawn of four ranks)."""
    rng = np.random.default_rng(0)
    ring_cases, ref = {}, {"ring": {}, "dense": {}}
    for name, (tmesh, jmesh, B, T, H, Hkv, D) in RING_CASES.items():
        q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (H, Hkv, Hkv))
        mesh = jmake_mesh(**jmesh, devices=devices8)
        ref["ring"][name] = np.asarray(jring_attention(jnp.asarray(q), jnp.asarray(k),
                                                       jnp.asarray(v), mesh))
        ref["dense"][name] = np.asarray(_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        ring_cases[name] = (tmesh, q, k, v)

    cfg = jget_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.key(3), dtype=jnp.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    mesh = jmake_mesh(dp=1, tp=2, sp=2, devices=devices8)
    pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32)[None], (2, 32))
    lg, kc, vc = jax.jit(lambda p, t: jllama.forward_prefill_ring(p, cfg, t, pos, mesh))(
        jshard_pytree(params, jllama.param_specs(cfg), mesh), jnp.asarray(tokens))
    ref["forward"] = dict(logits=np.asarray(lg), k=np.asarray(kc), v=np.asarray(vc))

    # The dense engine (sp = 1, tp = 2), TestLongContextServing's reference.
    long_prompt = [int(x) for x in np.random.default_rng(0).integers(1, 200, size=20)]
    session = [int(x) for x in np.random.default_rng(1).integers(1, 200, size=18)]
    short = [1, 2, 3]
    dense = JEngine(cfg, JEngineConfig(**ENGINE_BASE, tp=2), params=params, seed=0)
    ref["long"] = dense.generate(long_prompt, GREEDY)[0]
    ref["short"] = dense.generate(short, GREEDY)[0]
    a = dense.generate(session, GREEDY)[0]
    ref["session"] = [a, dense.generate(session + a + [7], GREEDY)[0]]
    dense = JEngine(cfg, JEngineConfig(**ENGINE_BASE, **K4, tp=2), params=params, seed=0)
    ref["k4_long"] = dense.generate(long_prompt, GREEDY)[0]

    engine_case = dict(cfg=dict(name="test-tiny"), tree=_np_tree(params), base=ENGINE_BASE,
                       long=long_prompt, short=short, session=session, k4=K4)
    got = spawn_ranks(workers.sp_job, 4,
                      args=(ring_cases, (dict(name="test-tiny"), _np_tree(params), tokens),
                            engine_case),
                      backend="gloo", env=env, timeout_s=300)
    return ref, got


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_jax_and_dense(sp_run, case):
    ref, got = sp_run
    for rank_out in got:
        np.testing.assert_allclose(rank_out[case], ref["ring"][case], **RING_TOL)
        np.testing.assert_allclose(rank_out[case], ref["dense"][case], **RING_TOL)


def test_forward_prefill_ring_matches_jax(sp_run):
    ref, got = sp_run
    for rank_out in got:
        for key in ("logits", "k", "v"):
            np.testing.assert_allclose(rank_out["forward"][key], ref["forward"][key],
                                       **FWD_TOL, err_msg=key)


def test_ring_prefill_matches_dense_engine(sp_run):
    ref, got = sp_run
    for rank_out in got:
        assert rank_out["long"] == ref["long"]
        assert rank_out["ring_after_long"] == 1      # the 32-token bucket took the ring
        # The ring's rows moved by point-to-point shifts; the chunk and
        # the last row's logits by a gather and a broadcast.
        assert rank_out["sp_ops"] == ["all_gather", "broadcast", "shift"]


def test_short_prompts_skip_the_ring(sp_run):
    """Below the threshold the dense program serves."""
    ref, got = sp_run
    for rank_out in got:
        assert rank_out["short"] == ref["short"]
        assert rank_out["ring_after_short"] == 1     # no ring dispatch for bucket 8


def test_sessionful_reuse_with_sp_mesh(sp_run):
    ref, got = sp_run
    for rank_out in got:
        assert rank_out["session"] == ref["session"]
        assert rank_out["session_ring"] == 1         # turn 1 rings, turn 2 extends
        assert rank_out["reuse"] > 0
        assert "ring:bucket32" in rank_out["warm_tasks"]
        assert "ring:bucket8" not in rank_out["warm_tasks"]


def test_ring_prefill_on_int8_paged_cache_matches_dense_engine(sp_run):
    ref, got = sp_run
    for rank_out in got:
        assert rank_out["k4_long"] == ref["k4_long"]
        assert rank_out["k4_ring"] == 1


def test_ring_prefill_on_dp_sp_mesh_matches_dense_engine(sp_run):
    ref, got = sp_run
    for rank_out in got:
        assert rank_out["dp_sp"] == [ref["long"], ref["session"][0]]
        assert rank_out["dp_sp_ring"] == 1           # each rank rings its own shard's slot

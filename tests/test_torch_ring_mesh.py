"""The decode ring (``decode_ring=2``) under tp, dp and sp, and the MoE
layer's dispatch over the whole dp batch, held against the JAX package on
the CPU. The port's ranks are four spawned processes of one gloo group
(one spawn; rank functions in ``torch_ring_workers.py``), JAX's mesh the
virtual CPU devices. On the CPU the port's ring is the eager edition.

- The ring at tp = 2 (the port's sp axis a replica: no prompt reaches
  the sp ring attention's threshold), dp = 2 x tp = 2 and sp = 2 x tp = 2
  (a 20-token prompt prefills as the sp ring attention), on the
  contiguous f32 cache and the int8 paged one: greedy tokens and finish
  reasons equal the JAX ``decode_ring=2`` engine's on the same mesh.
- The batch-wide early-out under dp: at dp = 2 x tp = 2 slots 0 and 1
  (shard 0) finish in a chunk whose later steps only shard 1 needs, and
  a late unseeded request then lands on slot 0. Every slot's sampler
  state, every sampled stream, the late one included, and the ring's
  books equal the port's dp = 1 ring engine's: shard 0 stepped with
  shard 1, as JAX's ``lax.cond`` on the whole batch's ``active`` does (a
  shard-local early-out leaves shard 0's counters behind and changes the
  late stream).
- The refusal: on the card a ring engine at dp or tp above 1 over gloo
  raises (its captured step would hold a gloo collective); sp alone
  passes the check.
- The MoE repair: test-tiny-moe with E = 8 and a skewed router (expert 0
  overflows its capacity; the drops are counted) at dp = 2 x tp = 2: the
  forward at the decode step's shape [64, 1] and at [4, 33] equals JAX's
  sharded forward (f32, 1e-3), and one ``train_step``'s loss and
  gradients equal JAX's ``value_and_grad`` on the same mesh (the
  tolerances of ``test_torch_train_mesh.py``). Inside the pipeline at
  pp = 2 x dp = 2 (M = 2, each microbatch's rows over both shards):
  ``pipeline_forward`` and ``pipeline_loss_fn``'s loss and gradients
  equal JAX's pipeline on the same mesh, with drops.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_ring_workers as workers
from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.ops.moe import DISPATCH_MIN_TOKENS
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu.parallel import pipeline_forward as jpipeline_forward
from omnia_tpu.parallel import shard_pytree as jshard_pytree
from omnia_tpu.train import trainer as jtrainer
from omnia_tpu_torch.parallel.launch import spawn_ranks
from omnia_tpu_torch.train import trainer

TOL = dict(rtol=1e-3, atol=1e-3)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# JAX's mesh of each case (the port's is workers.MESHES).
JAX_MESHES = {"tp2": dict(tp=2), "dp2_tp2": dict(dp=2, tp=2), "sp2_tp2": dict(sp=2, tp=2)}
MOE_SHAPES = ((64, 1), (4, 33))
MOE_TRAIN = (4, 33)
MOE_PP = (4, 33)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _jax_rows(cfg, params, dims, fields, devices) -> list:
    n = int(np.prod(list(dims.values())))
    eng = JEngine(cfg, JEngineConfig(**{**workers.RING_BASE, **fields, **dims}), params=params,
                  seed=0, devices=devices[:n])
    hs = [eng.submit(list(p), JSamplingParams(**kw))
          for p, kw in zip(workers.PROMPTS, workers.greedy_params())]
    while eng.step():
        pass
    out = []
    for h in hs:
        toks, fin = h.collect_tokens(timeout=60)
        out.append((toks, fin.finish_reason.value))
    return out


def _moe_model():
    """test-tiny-moe with E = 8 whose embeddings share a vector u that
    router column 0 points along: most rows of every layer rank expert 0
    first, so it overflows its capacity (N / 2 rows at factor 2)."""
    cfg = dataclasses.replace(jget_config("test-tiny-moe"), num_experts=8)
    params = _np_tree(jllama.init_params(cfg, jax.random.key(5), dtype=jnp.float32))
    u = np.random.default_rng(6).standard_normal(cfg.hidden_size).astype(np.float32) * 0.02
    params["embed"] += u
    params["layers"]["mlp"]["router"][:, :, 0] = 0.5 * u / np.linalg.norm(u)
    return cfg, params


def _jax_moe(cfg, params, devices) -> dict:
    """JAX's sharded forward at each shape and its loss and gradient, on
    the dp = 2 x tp = 2 mesh, with the inputs the ranks get."""
    mesh = jmake_mesh(dp=2, tp=2, devices=devices[:4])
    sharded = jshard_pytree(jax.tree.map(jnp.asarray, params), jllama.param_specs(cfg), mesh)
    rows = NamedSharding(mesh, JP("dp", None))
    kspec, vspec = jllama.kv_cache_specs()
    rng = np.random.default_rng(8)
    forwards, want = [], {}
    for B, T in MOE_SHAPES:
        tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        ck, cv = jllama.init_kv_cache(cfg, B, T + 7, dtype=jnp.float32)
        fwd = jax.jit(lambda p, t, q, k, v, s: jllama.forward(p, cfg, t, q, k, v, s))
        pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
        lg, _, _ = fwd(sharded, jax.device_put(jnp.asarray(tokens), rows), pos,
                       jax.device_put(ck, NamedSharding(mesh, kspec)),
                       jax.device_put(cv, NamedSharding(mesh, vspec)),
                       jnp.zeros((B,), jnp.int32))
        forwards.append(tokens)
        want[(B, T)] = np.asarray(lg)
    tok = rng.integers(1, cfg.vocab_size, MOE_TRAIN).astype(np.int32)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, t: jtrainer.loss_fn(p, cfg, t)))
    loss, grads = grad_fn(sharded, jax.device_put(jnp.asarray(tok), rows))
    want["train"] = (float(loss), _np_tree(grads))
    inputs = dict(forwards=forwards, train_tokens=tok)
    inputs.update(_jax_moe_pp(cfg, params, devices, rng, want))
    return inputs, want


def _jax_moe_pp(cfg, params, devices, rng, want) -> dict:
    """JAX's pipeline forward (M = 2) at [4, 33] and its pipeline loss
    and gradient at [4, 33] inputs, on the pp = 2 x dp = 2 mesh: each
    microbatch's 66 (and 64) rows take the dispatch branch."""
    mesh = jmake_mesh(dp=2, pp=2, devices=devices[:4])
    sharded = jshard_pytree(jax.tree.map(jnp.asarray, params), jllama.param_specs_pp(cfg), mesh)
    tokens = rng.integers(0, cfg.vocab_size, MOE_PP).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(MOE_PP[1], dtype=jnp.int32)[None], MOE_PP)
    lg, _, _ = jax.jit(lambda p, t, q: jpipeline_forward(p, cfg, t, q, mesh, 2))(
        sharded, jnp.asarray(tokens), pos)
    want["pp_forward"] = np.asarray(lg)
    train = rng.integers(1, cfg.vocab_size, (MOE_PP[0], MOE_PP[1] + 1)).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jtrainer.pipeline_loss_fn(p, cfg, t, mesh, 2)))(sharded, jnp.asarray(train))
    want["pp_train"] = (float(loss), _np_tree(grads))
    return dict(pp_tokens=tokens, pp_train_tokens=train)


@pytest.fixture(scope="module")
def ring_run(devices8, tmp_path_factory):
    cfg = jget_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.key(3), dtype=jnp.float32)
    want = {(name, cache): _jax_rows(cfg, params, dims, workers.CACHES[cache], devices8)
            for name, dims in JAX_MESHES.items() for cache in workers.CACHES}
    mcfg, mparams = _moe_model()
    moe_inputs, want["moe"] = _jax_moe(mcfg, mparams, devices8)
    moe_case = dict(cfg=dict(name="test-tiny-moe", num_experts=8), tree=mparams, **moe_inputs)
    env = {"OMNIA_WARMUP_MANIFEST_DIR": str(tmp_path_factory.mktemp("manifests"))}
    got = spawn_ranks(workers.ring_mesh_job, 4, args=(_np_tree(params), moe_case),
                      backend="gloo", env=env, timeout_s=600)
    return want, got, mcfg


@pytest.mark.parametrize("cache", list(workers.CACHES))
@pytest.mark.parametrize("mesh", list(JAX_MESHES))
def test_ring_tokens_equal_jax_on_the_mesh(ring_run, mesh, cache):
    """Greedy tokens and finish reasons of the port's ring engine equal
    the JAX ring engine's on the same mesh, on every rank; a dp shard
    holds half the slots."""
    want, got, _ = ring_run
    for r in got:
        run = r["ring"][(mesh, cache)]
        assert run["rows"] == want[(mesh, cache)]
        assert run["local_slots"] == (2 if mesh.startswith("dp") else 4)
        assert run["books"] == got[0]["ring"][(mesh, cache)]["books"]
        assert run["books"]["early_exit_steps"] > 0


def test_dp_ring_steps_every_shard_while_one_is_live(ring_run):
    """dp = 2 x tp = 2 against dp = 1, both rings, request i on slot i:
    every slot's sampler state after the batch, every sampled stream
    (seeded, slot-keyed, and the late request on slot 0, whose key shard
    0's idle steps advanced) and the ring's books are equal."""
    _, got, _ = ring_run
    for r in got:
        dp, one = r["dp"], r["dp1"]
        assert dp["slots"] and one["slots"]
        np.testing.assert_array_equal(dp["keys"], one["keys"])
        for key in ("batch", "late", "books"):
            assert dp[key] == one[key], key
        lengths = [len(toks) for toks, _ in dp["batch"]]
        assert lengths == [6, 6, 20, 20] and len(dp["late"][0][0]) == 6


def test_ring_collectives_over_gloo_are_refused_on_the_card(ring_run):
    """A tp or dp ring over gloo on the card raises, sp alone passes; over
    NCCL the ring needs NCCL's graph mixing off; the captured collectives'
    groups span the mesh's lines and are groups of their own."""
    _, got, _ = ring_run
    for r in got:
        ref = r["refusals"]
        for name in ("dp2_tp2", "sp2_tp2", "dp2_sp2"):
            assert ref[name] is not None and "NCCL, one rank per card" in ref[name], ref[name]
            assert "gloo" in ref[name]
        assert ref["sp4_allowed"] and ref["mixing_off_allowed"]
        assert "NCCL_GRAPH_MIXING_SUPPORT=0" in ref["mixing_on"]
        lines = r["capture_lines"]
        assert sorted(lines) == ["dp", "tp"]
        for mesh_line, capture_line, own in lines.values():
            assert capture_line == mesh_line and own


def _drops(routes: list, shards: int, E: int, K: int) -> int:
    """Assignments past capacity over every layer: each layer's routes
    joined in shard order (the ranks of tp index 0, one per dp shard)."""
    total = 0
    layers = len(routes[0])
    for i in range(layers):
        top_i = np.concatenate([routes[s][i] for s in range(shards)])
        N = top_i.shape[0]
        capacity = max(1, -(-N * K * 2 // E))
        counts = np.bincount(top_i.reshape(-1), minlength=E)
        total += int(np.maximum(counts - capacity, 0).sum())
    return total


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=["decode_64x1", "prefill_4x33"])
def test_moe_dp_forward_equals_jax_and_drops(ring_run, shape):
    want, got, cfg = ring_run
    assert shape[0] * shape[1] >= DISPATCH_MIN_TOKENS      # the dispatch branch
    for r in got:
        np.testing.assert_allclose(r["moe"][shape]["logits"], want["moe"][shape], **TOL)
    # Ranks 0 and 2 hold tp index 0 of dp shards 0 and 1.
    routes = [got[0]["moe"][shape]["routes"], got[2]["moe"][shape]["routes"]]
    assert len(routes[0]) == cfg.num_layers
    assert _drops(routes, 2, cfg.num_experts, cfg.num_experts_per_tok) > 0


def test_moe_dp_train_step_equals_jax(ring_run):
    want, got, cfg = ring_run
    jloss, jgrads = want["moe"]["train"]
    for r in got:
        assert abs(r["moe"]["train"]["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
    routes = [got[0]["moe"]["train"]["routes"], got[2]["moe"]["train"]["routes"]]
    assert _drops(routes, 2, cfg.num_experts, cfg.num_experts_per_tok) > 0
    ref = dict(trainer.leaves(jgrads))
    whole = dict(trainer.leaves(got[0]["moe"]["train"]["grads"]))
    assert whole.keys() == ref.keys()
    for path, g in whole.items():
        scale = np.abs(ref[path]).max()
        assert np.abs(g - ref[path]).max() <= GRAD_RTOL * scale, path


def _stage_routes(got: list) -> list:
    """Per pp stage, its two dp shards' routes (dp order) of each case."""
    by = {}
    for r in got:
        c = r["moe_pp"]["coords"]
        by.setdefault(c.get("pp", 0), {})[c.get("dp", 0)] = r["moe_pp"]
    return [[shards[d] for d in sorted(shards)] for _, shards in sorted(by.items())]


@pytest.mark.parametrize("case", ["forward", "train"])
def test_moe_dp_inside_the_pipeline_equals_jax_and_drops(ring_run, case):
    """pp = 2 x dp = 2: every rank's logits (forward) or loss and whole
    gradient (train) equal JAX's pipeline; every stage's layers drop."""
    want, got, cfg = ring_run
    if case == "forward":
        for r in got:
            np.testing.assert_allclose(r["moe_pp"]["forward"]["logits"], want["moe"]["pp_forward"],
                                       **TOL)
    else:
        jloss, jgrads = want["moe"]["pp_train"]
        for r in got:
            assert abs(r["moe_pp"]["train"]["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
        ref = dict(trainer.leaves(jgrads))
        whole = dict(trainer.leaves(got[0]["moe_pp"]["train"]["grads"]))
        assert whole.keys() == ref.keys()
        for path, g in whole.items():
            scale = np.abs(ref[path]).max()
            assert np.abs(g - ref[path]).max() <= GRAD_RTOL * scale, path
    for shards in _stage_routes(got):
        routes = [s[case]["routes"] for s in shards]
        assert len(routes[0]) == 2 * cfg.num_layers // 2      # M x the stage's layers
        assert _drops(routes, 2, cfg.num_experts, cfg.num_experts_per_tok) > 0

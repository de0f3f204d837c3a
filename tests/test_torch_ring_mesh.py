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
  tolerances of ``test_torch_train_mesh.py``). At B = 3, which dp = 2
  does not divide (GSPMD's blocks: shard 1 holds one row and a padding
  row, which takes no expert slot), one step's loss equals JAX's sharded
  step's and its gradients JAX's ``value_and_grad``, with drops. Inside
  the pipeline at pp = 2 x dp = 2: ``pipeline_forward`` and
  ``pipeline_loss_fn``'s loss and gradients equal JAX's pipeline on the
  same mesh, with drops, at M = 2 (each microbatch's rows over both
  shards) and at B = 4, M = 4 (each microbatch's one row on shard 0).
- The MoE ring at tp = 4 (test-tiny-moe, E = 8, 4 KV heads: two experts
  and one KV head a rank): ring on and off, greedy tokens equal the JAX
  engine's at tp = 4; a 40-token prompt prefills in the 64-row bucket
  (capacity dispatch), decode steps take the all-expert path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
MOE_TRAIN_UNEVEN = (3, 23)        # 66 rows: the dispatch branch
MOE_PP = (4, 33)
MOE_PP_UNEVEN = (4, 64)           # M = 4: a microbatch's one row, 64 tokens


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _jax_rows(cfg, params, dims, fields, devices, prompts=workers.PROMPTS,
              sampling=None) -> list:
    n = int(np.prod(list(dims.values())))
    eng = JEngine(cfg, JEngineConfig(**{**workers.RING_BASE, **fields, **dims}), params=params,
                  seed=0, devices=devices[:n])
    hs = [eng.submit(list(p), JSamplingParams(**kw))
          for p, kw in zip(prompts, sampling or workers.greedy_params())]
    while eng.step():
        pass
    out = []
    for h in hs:
        toks, fin = h.collect_tokens(timeout=60)
        out.append((toks, fin.finish_reason.value))
    return out


def _moe_model(**fields):
    """test-tiny-moe with E = 8 (and ``fields``) whose embeddings share a
    vector u that router column 0 points along: most rows of every layer
    rank expert 0 first, so it overflows its capacity (N / 2 rows at
    factor 2)."""
    cfg = dataclasses.replace(jget_config("test-tiny-moe"), num_experts=8, **fields)
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
    inputs["pp"] = {2: _jax_moe_pp(cfg, params, devices, rng, want, MOE_PP, 2)}
    inputs["train_uneven_tokens"] = _jax_moe_uneven(cfg, sharded, params, mesh, rng, want)
    inputs["pp"][4] = _jax_moe_pp(cfg, params, devices, rng, want, MOE_PP_UNEVEN, 4)
    return inputs, want


def _jax_moe_uneven(cfg, sharded, params, mesh, rng, want) -> np.ndarray:
    """JAX's sharded train_step at MOE_TRAIN_UNEVEN on the dp = 2 x tp = 2
    mesh for the loss; ``value_and_grad`` of ``loss_fn`` for the
    gradient (the sharded step's carries a padding row's spurious
    ``embed[0]`` gradient: ``test_torch_train_mesh.py``)."""
    tok = rng.integers(1, cfg.vocab_size, MOE_TRAIN_UNEVEN).astype(np.int32)
    _, grads = jax.value_and_grad(jtrainer.loss_fn)(jax.tree.map(jnp.asarray, params), cfg,
                                                    jnp.asarray(tok))
    opt = optax.adamw(1e-2)
    _, step = jtrainer.make_train_step(cfg, opt, mesh=mesh)
    state = jtrainer.TrainState(params=sharded, opt_state=opt.init(sharded),
                                step=jnp.zeros((), jnp.int32))
    _, loss = step(state, jnp.asarray(tok))
    want["train_uneven"] = (float(loss), _np_tree(grads))
    return tok


def _jax_moe_pp(cfg, params, devices, rng, want, shape, m) -> tuple:
    """JAX's pipeline forward (M = m) at ``shape`` and its pipeline loss
    and gradient at one more token a row, on the pp = 2 x dp = 2 mesh:
    each microbatch's 66 (M = 2) or 64 (M = 4) rows take the dispatch
    branch. Returns the ranks' (forward, train) tokens."""
    mesh = jmake_mesh(dp=2, pp=2, devices=devices[:4])
    sharded = jshard_pytree(jax.tree.map(jnp.asarray, params), jllama.param_specs_pp(cfg), mesh)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(shape[1], dtype=jnp.int32)[None], shape)
    lg, _, _ = jax.jit(lambda p, t, q: jpipeline_forward(p, cfg, t, q, mesh, m))(
        sharded, jnp.asarray(tokens), pos)
    want[("pp_forward", m)] = np.asarray(lg)
    train = rng.integers(1, cfg.vocab_size, (shape[0], shape[1] + 1)).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jtrainer.pipeline_loss_fn(p, cfg, t, mesh, m)))(sharded, jnp.asarray(train))
    want[("pp_train", m)] = (float(loss), _np_tree(grads))
    return tokens, train


@pytest.fixture(scope="module")
def ring_run(devices8, tmp_path_factory):
    cfg = jget_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.key(3), dtype=jnp.float32)
    want = {(name, cache): _jax_rows(cfg, params, dims, workers.CACHES[cache], devices8)
            for name, dims in JAX_MESHES.items() for cache in workers.CACHES}
    mcfg, mparams = _moe_model()
    moe_inputs, want["moe"] = _jax_moe(mcfg, mparams, devices8)
    # The MoE ring at dp = 2 x tp = 2 with 64 slots against JAX's one
    # device with 64: the same dispatch over the same 64 rows a step.
    want["moe_dp_ring"] = _jax_rows(mcfg, mparams, {},
                                    dict(num_slots=workers.MOE_DP_RING_SLOTS), devices8,
                                    *workers.moe_dp_ring_requests(mcfg.vocab_size))
    rcfg, rparams = _moe_model(num_kv_heads=4)
    want["moe_ring"] = _jax_rows(rcfg, rparams, dict(tp=4), workers.MOE_RING, devices8,
                                 workers.MOE_RING_PROMPTS)
    moe_case = dict(cfg=dict(name="test-tiny-moe", num_experts=8), tree=mparams,
                    ring_cfg=dict(name="test-tiny-moe", num_experts=8, num_kv_heads=4),
                    ring_tree=rparams, **moe_inputs)
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


def _drops(routes: list, shards: int, E: int, real=None) -> int:
    """Assignments past capacity over every layer: each layer's routes
    joined in shard order (the ranks of tp index 0, one per dp shard),
    each shard's first ``real[s]`` rows (all without ``real``: the rest
    are padding)."""
    return sum(workers.overflow(np.concatenate([routes[s][i][:None if real is None else real[s]]
                                                for s in range(shards)]), E)
               for i in range(len(routes[0])))


@pytest.mark.parametrize("shape", MOE_SHAPES, ids=["decode_64x1", "prefill_4x33"])
def test_moe_dp_forward_equals_jax_and_drops(ring_run, shape):
    want, got, cfg = ring_run
    assert shape[0] * shape[1] >= DISPATCH_MIN_TOKENS      # the dispatch branch
    for r in got:
        np.testing.assert_allclose(r["moe"][shape]["logits"], want["moe"][shape], **TOL)
    # Ranks 0 and 2 hold tp index 0 of dp shards 0 and 1.
    routes = [got[0]["moe"][shape]["routes"], got[2]["moe"][shape]["routes"]]
    assert len(routes[0]) == cfg.num_layers
    assert _drops(routes, 2, cfg.num_experts) > 0


def _assert_grads(jgrads, grads) -> None:
    ref = dict(trainer.leaves(jgrads))
    whole = dict(trainer.leaves(grads))
    assert whole.keys() == ref.keys()
    for path, g in whole.items():
        scale = np.abs(ref[path]).max()
        assert np.abs(g - ref[path]).max() <= GRAD_RTOL * scale, path


def _check_train_step(ring_run, case: str, real=None) -> None:
    want, got, cfg = ring_run
    jloss, jgrads = want["moe"][case]
    for r in got:
        assert abs(r["moe"][case]["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
    routes = [got[0]["moe"][case]["routes"], got[2]["moe"][case]["routes"]]
    assert _drops(routes, 2, cfg.num_experts, real) > 0
    _assert_grads(jgrads, got[0]["moe"][case]["grads"])


def test_moe_dp_train_step_equals_jax(ring_run):
    _check_train_step(ring_run, "train")


def test_moe_dp_train_step_on_uneven_shards_equals_jax(ring_run):
    """B = 3 over dp = 2 (GSPMD's blocks: shard 1 one row and a padding
    row, which the drops leave out): every row trained, as JAX trains it."""
    T = MOE_TRAIN_UNEVEN[1] - 1
    _check_train_step(ring_run, "train_uneven", real=[2 * T, T])


def _stage_routes(got: list, m: int) -> list:
    """Per pp stage, its two dp shards' routes (dp order) of each case."""
    by = {}
    for r in got:
        c = r["moe_pp"]["coords"]
        by.setdefault(c.get("pp", 0), {})[c.get("dp", 0)] = r["moe_pp"][m]
    return [[shards[d] for d in sorted(shards)] for _, shards in sorted(by.items())]


def _check_pipeline(ring_run, case: str, m: int, real=None) -> None:
    """pp = 2 x dp = 2, M = m: every rank's logits (forward) or loss and
    whole gradient (train) equal JAX's pipeline; every stage's layers
    drop."""
    want, got, cfg = ring_run
    if case == "forward":
        for r in got:
            np.testing.assert_allclose(r["moe_pp"][m]["forward"]["logits"],
                                       want["moe"][("pp_forward", m)], **TOL)
    else:
        jloss, jgrads = want["moe"][("pp_train", m)]
        for r in got:
            assert abs(r["moe_pp"][m]["train"]["loss"] - jloss) <= LOSS_RTOL * abs(jloss)
        _assert_grads(jgrads, got[0]["moe_pp"][m]["train"]["grads"])
    for shards in _stage_routes(got, m):
        routes = [s[case]["routes"] for s in shards]
        assert len(routes[0]) == m * cfg.num_layers // 2      # M x the stage's layers
        assert _drops(routes, 2, cfg.num_experts, real) > 0


@pytest.mark.parametrize("case", ["forward", "train"])
def test_moe_dp_inside_the_pipeline_equals_jax_and_drops(ring_run, case):
    """M = 2: each microbatch's two rows over both shards."""
    _check_pipeline(ring_run, case, 2)


@pytest.mark.parametrize("case", ["forward", "train"])
def test_moe_dp_inside_the_pipeline_on_uneven_shards_equals_jax(ring_run, case):
    """B = 4, M = 4: each microbatch's one row on dp shard 0, shard 1
    padding, which takes no expert slot (once refused by the port)."""
    _check_pipeline(ring_run, case, 4, real=[MOE_PP_UNEVEN[1], 0])


def test_moe_ring_at_tp4_equals_jax(ring_run):
    """test-tiny-moe, E = 8, at tp = 4: the eager ring and ring off give
    the JAX tp = 4 engine's greedy tokens and finishes on every rank."""
    want, got, _ = ring_run
    for r in got:
        assert r["moe_ring"]["on"] == r["moe_ring"]["off"] == want["moe_ring"]


def test_moe_dp_ring_at_64_rows_equals_jax_and_drops(ring_run):
    """test-tiny-moe, E = 8, skewed router, at dp = 2 x tp = 2 with 32
    slots a shard: every decode step of the eager ring is 64 global rows
    and takes the capacity dispatch (C = 32). The greedy tokens and
    finishes equal the JAX ring engine's with 64 slots on one device, on
    every rank; each MoE layer of each step that ran all-gathered its
    counts over dp once; the whole batch's routes overflow expert 0."""
    want, got, cfg = ring_run
    for r in got:
        run = r["moe_dp_ring"]
        assert run["rows"] == want["moe_dp_ring"]
        assert run["books"] == got[0]["moe_dp_ring"]["books"]
        ran = run["books"]["decode_steps"] - run["books"]["early_exit_steps"]
        assert len(run["gathers"]) == run["layers"] * ran and set(run["gathers"]) == {1}
    # Ranks 0 and 2 hold tp index 0 of dp shards 0 and 1: each call's
    # routes over the whole batch, shard 0's rows first.
    shards = [got[0]["moe_dp_ring"]["routes"], got[2]["moe_dp_ring"]["routes"]]
    assert len(shards[0]) == len(shards[1]) > 0
    assert _drops(shards, 2, cfg.num_experts) > 0

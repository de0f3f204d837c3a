"""Data parallelism in the port against the JAX package, on the CPU: the
port's ranks are four spawned processes in one gloo group at dp = 2 x
tp = 2 (``parallel/launch.py``, rank functions in
``torch_dpsp_workers.py``), JAX's mesh four of the 8 virtual CPU devices.

- The analog of ``tests/test_llama.py::test_sharded_forward_matches_single_device``:
  the forward's logits and KV caches at dp = 2 x tp = 2, each dp shard
  running its batch rows, equal JAX's sharded forward (f32, 1e-3).
- The analogs of ``tests/test_engine_sessions.py::TestSessionsOnMesh``:
  greedy tokens of a session script at dp = 2 x tp = 2 equal the JAX
  engine's on the same mesh, with KV reuse and host paging (six sessions
  on four slots), and a session that resumes on a slot of the other
  shard; on the contiguous cache with a shared-prefix pool (a registered
  prefix seeds slots of both shards from entries of either), on the
  paged cache with the pool (every slot's pages from its own shard; a
  cross-shard seed copies the entry's pages), on the int8 cache, with
  int8 weights, and with stall-free batching, speculation and grammar
  support on (tokens against the JAX engine with them off), after a
  warmup. test-tiny-moe's greedy rows at dp = 2 x tp = 2 equal the JAX
  MoE engine's on the same mesh.
- A sampled batch (seeded and unseeded) at dp = 2 x tp = 2 gives the
  port's dp = tp = 1 engine's tokens on the f32 caches: the sampler is the port's own
  (``ops/sampling.py``: JAX's threefry streams are not reproduced), so a
  seeded request's stream, and an unseeded one's from its slot's key,
  must not depend on which shard serves it. Its greedy rows equal JAX's.
- ``export_session`` of a session on the other shard from the leader's
  gives the payload a dp = tp = 1 engine gives after the same script.
- ``build_engine`` under the env contract at dp = 2 x tp = 2 from a
  checkpoint gives a LockstepEngine serving the dp = 1 engine's tokens.
- The dp divisibility messages equal the JAX engine's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_dpsp_workers as workers
from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.engine.paged import dp_divisibility_error as jdp_divisibility_error
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu.parallel import shard_pytree as jshard_pytree
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine
from omnia_tpu_torch.engine.paged import dp_divisibility_error
from omnia_tpu_torch.models import checkpoint as ckpt_io
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.launch import spawn_ranks

TOL = dict(rtol=1e-3, atol=1e-3)
BASE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 16), dtype="float32",
            max_sessions=8, prefix_cache_min_tokens=4)
SYS = [11, 12, 13, 14, 15, 16, 17, 18]
# Port configs at dp = 2 x tp = 2, each with the JAX config it is held to.
CONFIGS = {
    "prefix": dict(prefix_cache_slots=2),
    "prefix_paged": dict(prefix_cache_slots=2, kv_pages=24, kv_page_tokens=8),
    "int8": dict(kv_quant="int8"),
    "quant": dict(quant="int8"),
    "warm": dict(prefill_chunk_tokens=8, spec_decode=2, grammar=True, grammar_max_states=8),
}
JAX_CONFIG = {"prefix": "prefix", "prefix_paged": "prefix_paged", "int8": "int8",
              "quant": "quant", "warm": "prefix"}
# Six sessions on four slots: e and f page a and b out, a's return pages
# c out and lands on c's slot, on the other shard; c comes back after.
TURNS = [("a", SYS + [1, 2, 3]), ("b", SYS + [4, 5]), ("c", SYS + [6, 7, 8]),
         ("d", SYS + [9]), ("e", SYS + [10, 19]), ("f", SYS + [20]),
         ("a", [21, 22]), ("c", [23])]
BATCH = ([[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7, 1, 8]],
         [dict(temperature=0.0, max_tokens=6),
          dict(temperature=0.8, max_tokens=6, seed=1234),
          dict(temperature=0.8, max_tokens=6),
          dict(temperature=0.0, max_tokens=6)])
METRICS = ("prefix_cache_hit_tokens", "session_offloads", "session_restores",
           "prefix_reuse_tokens")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return {"OMNIA_WARMUP_MANIFEST_DIR": str(tmp_path_factory.mktemp("manifests"))}


def _jax_script(cfg, params, fields, devices):
    """The JAX engine at dp = 2 x tp = 2: the batch's greedy rows and the
    session script's replies."""
    eng = JEngine(cfg, JEngineConfig(**BASE, **fields, dp=2, tp=2), params=params, seed=0,
                  devices=devices)
    if fields.get("prefix_cache_slots"):
        eng.register_prefix(SYS)
    hs = [eng.submit(p, JSamplingParams(**kw)) for p, kw in zip(*BATCH)]
    while eng.step():
        pass
    batch = [h.collect_tokens(timeout=30)[0] for h in hs]
    history, replies = {}, []
    for sid, new in TURNS:
        prompt = history.get(sid, []) + list(new)
        h = eng.submit(prompt, JSamplingParams(temperature=0.0, max_tokens=5), session_id=sid)
        while eng.step():
            pass
        reply = h.collect_tokens(timeout=30)[0]
        history[sid] = prompt + reply
        replies.append(reply)
    return dict(batch=batch, turns=replies,
                metrics={k: eng.metrics[k] for k in METRICS})


@pytest.fixture(scope="module")
def dp_run(env, devices8, tmp_path_factory):
    """Both sides of every check (one spawn of four ranks)."""
    cfg = jget_config("test-tiny")
    params = jllama.init_params(cfg, jax.random.key(7), dtype=jnp.float32)
    rng = np.random.default_rng(4)
    B, T, S = 2, 4, 8
    tokens = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    mesh = jmake_mesh(dp=2, tp=2, devices=devices8)
    ck, cv = jllama.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    kspec, vspec = jllama.kv_cache_specs()
    fwd = jax.jit(lambda p, t, q, k, v, s: jllama.forward(p, cfg, t, q, k, v, s))
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    lg, ck, cv = fwd(jshard_pytree(params, jllama.param_specs(cfg), mesh),
                     jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, JP("dp", None))),
                     pos, jax.device_put(ck, NamedSharding(mesh, kspec)),
                     jax.device_put(cv, NamedSharding(mesh, vspec)), jnp.zeros((B,), jnp.int32))
    ref = {"forward": dict(logits=np.asarray(lg), k=np.asarray(ck), v=np.asarray(cv))}
    devices = devices8[:4]
    for name in sorted(set(JAX_CONFIG.values())):
        ref[name] = _jax_script(cfg, params, CONFIGS[name], devices)
    mcfg = jget_config("test-tiny-moe")
    mparams = jllama.init_params(mcfg, jax.random.key(8), dtype=jnp.float32)
    meng = JEngine(mcfg, JEngineConfig(**BASE, dp=2, tp=2), params=mparams, seed=0,
                   devices=devices)
    greedy = [(p, kw) for p, kw in zip(*BATCH) if kw["temperature"] == 0.0]
    hs = [meng.submit(p, JSamplingParams(**kw)) for p, kw in greedy]
    while meng.step():
        pass
    ref["moe"] = [h.collect_tokens(timeout=30)[0] for h in hs]
    engine_case = dict(cfg=dict(name="test-tiny"), tree=_np_tree(params), base=BASE,
                       configs=CONFIGS, sys=SYS, turns=TURNS, batch=BATCH, metrics=METRICS,
                       moe=(dict(name="test-tiny-moe"), _np_tree(mparams)))
    path = str(tmp_path_factory.mktemp("ckpt-dp"))
    ckpt_io.save_params(params_from_jax(_np_tree(params), "cpu"), get_config("test-tiny"), path)
    options = dict(BASE, dp=2, tp=2, prefill_buckets=list(BASE["prefill_buckets"]),
                   checkpoint_path=path)
    provider = dict(spec=dict(name="dp", type="tpu", model="tiny-ckpt", options=options),
                    prompt=BATCH[0][0])
    got = spawn_ranks(workers.dp_job, 4,
                      args=((dict(name="test-tiny"), _np_tree(params), tokens), engine_case,
                            provider),
                      backend="gloo", env=env, timeout_s=400)
    return ref, got


def test_sharded_forward_matches_jax(dp_run):
    ref, got = dp_run
    for rank_out in got:
        for key in ("logits", "k", "v"):
            np.testing.assert_allclose(rank_out["forward"][key], ref["forward"][key], **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_session_script_on_dp_tp_mesh_matches_jax(dp_run, name):
    """KV reuse, host paging and a resume on the other shard; tokens equal
    the JAX engine's on the same mesh, every rank alike."""
    ref, got = dp_run
    want = ref[JAX_CONFIG[name]]
    for rank_out in got:
        out = rank_out[name]
        assert out["turns"] == want["turns"]
        assert out["turns"] == got[0][name]["turns"]
        assert out["local_slots"] == 2                     # half the slots per shard
        # Session a: shard 0 on its first turn, shard 1 when it resumes.
        first_a, again_a = TURNS.index(("a", TURNS[0][1])), TURNS.index(("a", [21, 22]))
        assert out["shards"][first_a] == 0 and out["shards"][again_a] == 1, out["shards"]
        assert out["metrics"]["session_restores"] >= 2
    if name == "prefix":
        # The contiguous pool seeds exactly as the JAX engine's does.
        assert got[0][name]["metrics"] == want["metrics"]


def test_paged_slots_take_pages_of_their_own_shard(dp_run):
    _, got = dp_run
    for rank_out in got:
        out = rank_out["prefix_paged"]
        assert out["own_pages"] and all(out["own_pages"])
        assert out["local_pages"] == 12                    # kv_pages // dp
        assert out["metrics"]["prefix_cache_hit_tokens"] > 0


def test_sampled_batch_is_the_single_engines(dp_run):
    """The port's sampler streams do not depend on the shard: seeded and
    slot-keyed requests at dp = 2 x tp = 2 give the dp = tp = 1 engine's
    tokens; the greedy rows also equal JAX's."""
    ref, got = dp_run
    for rank_out in got:
        for name in CONFIGS:
            if name not in ("int8", "quant"):    # int8 logits are not f32's
                assert rank_out[name]["batch"] == rank_out["one_batch"], name
            for i, kw in enumerate(BATCH[1]):
                if kw["temperature"] == 0.0:
                    assert rank_out[name]["batch"][i] == ref[JAX_CONFIG[name]]["batch"][i]


@pytest.mark.parametrize("fields,name,value", [
    (dict(num_slots=3), None, None),
    (dict(prefix_cache_slots=3), "prefix_cache_slots", 3),
    (dict(kv_pages=7), "kv_pages", 7),
])
def test_dp_divisibility_messages_equal_jax(fields, name, value, devices8):
    jcfg = JEngineConfig(**dict(BASE, **fields), dp=2)
    with pytest.raises(ValueError) as jerr:
        JEngine(jget_config("test-tiny"), jcfg, devices=devices8[:2])
    with pytest.raises(ValueError) as terr:
        InferenceEngine(get_config("test-tiny"), EngineConfig(**dict(BASE, **fields), dp=2),
                        device="cpu")
    assert str(terr.value) == str(jerr.value)
    if name is not None:
        assert str(terr.value) == jdp_divisibility_error(name, value, 2)
        for v, dp in ((7, 4), (3, 2), (1, 4)):
            assert dp_divisibility_error(name, v, dp) == jdp_divisibility_error(name, v, dp)


def test_export_from_the_other_shard_equals_the_single_engines(dp_run):
    """Session c sits on shard 1; every rank exports it (host rows are on
    every rank, every head gathered over tp) and gets the payload of a
    dp = tp = 1 engine that ran the same script."""
    _, got = dp_run
    want_ids, want_k, want_v = got[0]["one_export"]
    for rank_out in got:
        assert rank_out["prefix"]["export_shard"] == 1
        ids, k, v = rank_out["prefix"]["export"]
        assert ids == want_ids
        assert k.shape == want_k.shape and k.shape[2] == get_config("test-tiny").num_kv_heads
        np.testing.assert_allclose(k, want_k, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v, want_v, rtol=1e-5, atol=1e-5)


def test_provider_builds_a_lockstep_engine_at_dp_tp(dp_run):
    _, got = dp_run
    for rank_out in got:
        assert rank_out["provider_type"] == "LockstepEngine"
        assert rank_out["provider_slots"] == 2
    assert got[0]["provider_tokens"] == got[0]["one_batch"][0]


def test_moe_on_dp_tp_mesh_matches_jax(dp_run):
    """test-tiny-moe's experts split over tp inside each dp shard; its
    greedy rows equal the JAX MoE engine's (below 64 rows both take the
    all-expert path, so the shard's batch changes no branch)."""
    ref, got = dp_run
    for rank_out in got:
        assert rank_out["moe"] == ref["moe"]

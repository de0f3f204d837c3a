"""Tensor parallelism in the port against the JAX package's sharded runs,
on the CPU: the port's ranks are spawned processes in one gloo group
(``parallel/launch.py``), JAX's mesh the 8 virtual CPU devices.

- The analog of ``tests/test_llama.py::test_sharded_forward_matches_single_device``:
  prefill and decode logits and KV caches at tp = 2 equal JAX's forward
  on a ``make_mesh(dp=1, tp=2)`` mesh (f32, rtol/atol 1e-3), untied and
  tied embeddings; each rank holds half the KV heads; the params' shard
  -> gather round trip is exact.
- The analog of ``test_sharded_moe_matches_single_device``: test-tiny-moe
  at tp = 4, both MoE branches (8 rows: all experts; 80: capacity
  dispatch). test-tiny-moe's 2 KV heads do not split 4 ways in the port
  (GSPMD pads them), so this edition has 4.
- ``load_params(mesh=)`` gives each rank its slice of the whole load
  (f32, both int8 modes, MoE), and ``build_engine`` under the env
  contract gives a LockstepEngine serving the tokens of a tp = 1
  ``build_engine``.
- The analog of ``tests/test_quant.py::test_engine_on_mesh_quantized``:
  W8A16 and W8A8 at tp = 4 on test-tiny-gqa8, greedy tokens equal to the
  JAX int8 engine at tp = 4, and the forward's logits within 1e-5 of
  JAX's sharded forward (W8A8's activation amax is a MAX over the ranks;
  a rank's own amax moves them by far more)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_tp_workers as workers
from omnia_tpu.engine import EngineConfig as JEngineConfig
from omnia_tpu.engine import InferenceEngine as JEngine
from omnia_tpu.engine import SamplingParams as JSamplingParams
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.models import quant as jquant
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu.parallel import shard_pytree as jshard_pytree
from omnia_tpu_torch.engine import SamplingParams
from omnia_tpu_torch.models import checkpoint as ckpt_io
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.launch import spawn_ranks
from omnia_tpu_torch.runtime.providers import ProviderSpec, build_engine

TOL = dict(rtol=1e-3, atol=1e-3)
ENGINE_FIELDS = dict(num_slots=2, max_seq=64, prefill_buckets=(16,), dtype="float32",
                     max_sessions=0)
PROMPTS = [[1, 2, 3], [7, 5, 3, 1, 9]]
MOE_CFG = dict(name="test-tiny-moe", num_kv_heads=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return {"OMNIA_WARMUP_MANIFEST_DIR": str(tmp_path_factory.mktemp("manifests"))}


def _jax_forward(cfg, params, tokens, nxt, mesh):
    """JAX's sharded prefill + decode over a cache of 8 rows."""
    B, T = tokens.shape
    ck, cv = jllama.init_kv_cache(cfg, B, 8, dtype=jnp.float32)
    kspec, vspec = jllama.kv_cache_specs()
    ck = jax.device_put(ck, NamedSharding(mesh, kspec))
    cv = jax.device_put(cv, NamedSharding(mesh, vspec))
    sh = jshard_pytree(params, jllama.param_specs(cfg), mesh)
    fwd = jax.jit(lambda p, t, q, k, v, s: jllama.forward(p, cfg, t, q, k, v, s))
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    lg, ck, cv = fwd(sh, jnp.asarray(tokens), pos, ck, cv, jnp.zeros((B,), jnp.int32))
    lg1, ck, cv = fwd(sh, jnp.asarray(nxt), jnp.full((B, 1), T, jnp.int32), ck, cv,
                      jnp.full((B,), T, jnp.int32))
    return dict(prefill=np.asarray(lg), decode=np.asarray(lg1), k=np.asarray(ck),
                v=np.asarray(cv))


PROVIDER = dict(name="tp", type="tpu", model="tiny-ckpt",
                options=dict(tp=2, num_slots=2, max_seq=64, prefill_buckets=[16],
                             dtype="float32", max_sessions=0))


@pytest.fixture(scope="module")
def tp2(env, devices8, tmp_path_factory):
    """Both sides of the tp = 2 checks (one spawn of two ranks)."""
    mesh = jmake_mesh(dp=1, tp=2, devices=devices8)
    rng = np.random.default_rng(4)
    cases, ref = {}, {}
    for name, kw, key in (("untied", dict(name="test-tiny"), 3),
                          ("tied", dict(name="test-tiny", tie_embeddings=True), 5)):
        cfg = jget_config(**kw)
        params = jllama.init_params(cfg, jax.random.key(key), dtype=jnp.float32)
        tokens = rng.integers(0, cfg.vocab_size, size=(2, 4)).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        cases[name] = (kw, _np_tree(params), tokens, nxt)
        ref[name] = _jax_forward(cfg, params, tokens, nxt, mesh)
    ckpts = {}
    for name, kw in (("dense", dict(name="test-tiny")), ("moe", dict(name="test-tiny-moe"))):
        path = str(tmp_path_factory.mktemp(f"ckpt-{name}"))
        params = jllama.init_params(jget_config(**kw), jax.random.key(6), dtype=jnp.float32)
        ckpt_io.save_params(params_from_jax(_np_tree(params), "cpu"), get_config(**kw), path)
        ckpts[name] = path
    spec = dict(PROVIDER, options=dict(PROVIDER["options"], checkpoint_path=ckpts["dense"]))
    one = build_engine(ProviderSpec.from_dict(dict(spec, options=dict(spec["options"], tp=1))),
                       device="cpu")
    h = one.submit(PROMPTS[1], SamplingParams(temperature=0.0, max_tokens=8))
    while one.step():
        pass
    ref["provider_tokens"] = h.collect_tokens(timeout=30)[0]
    got = spawn_ranks(workers.tp2_job, 2, args=(cases, ckpts, (spec, PROMPTS[1])),
                      backend="gloo", env=env, timeout_s=300)
    return ref, got


@pytest.mark.parametrize("name", ["untied", "tied"])
def test_sharded_forward_matches_jax(tp2, name):
    ref, got = tp2
    for rank_out in got:
        out = rank_out[name]
        for key in ("prefill", "decode", "k", "v"):
            np.testing.assert_allclose(out[key], ref[name][key], **TOL, err_msg=key)
        assert out["local_heads"] == 1      # test-tiny's 2 KV heads over 2 ranks
        assert out["round_trip"]
    # Every rank holds the same gathered logits (their samplers agree).
    assert np.array_equal(got[0][name]["decode"], got[1][name]["decode"])


@pytest.fixture(scope="module")
def tp4(env, devices8):
    """Both sides of the tp = 4 checks (one spawn of four ranks)."""
    rng = np.random.default_rng(5)
    mcfg = jget_config(**MOE_CFG)
    mparams = jllama.init_params(mcfg, jax.random.key(2), dtype=jnp.float32)
    token_sets = [rng.integers(0, mcfg.vocab_size, size=s).astype(np.int32)
                  for s in ((2, 4), (2, 40))]
    mesh = jmake_mesh(dp=1, tp=4, devices=devices8)
    sh = jshard_pytree(mparams, jllama.param_specs(mcfg), mesh)
    fwd = jax.jit(lambda p, t: jllama.forward_train(p, mcfg, t))
    ref = {"moe": [np.asarray(fwd(sh, jnp.asarray(t))) for t in token_sets]}

    qcfg = jget_config("test-tiny-gqa8")
    qparams = jllama.init_params(qcfg, jax.random.key(0), dtype=jnp.float32)
    tokens = rng.integers(0, qcfg.vocab_size, size=(2, 6)).astype(np.int32)
    pos = jnp.broadcast_to(jnp.arange(6, dtype=jnp.int32)[None], (2, 6))
    for mode in ("int8", "int8-dynamic"):
        qp = jquant.quantize_params(qparams, qcfg, mode)
        specs = jquant.quantize_param_specs(jllama.param_specs(qcfg), qcfg, mode)
        lg = jax.jit(lambda p, t: jllama.forward_prefill(p, qcfg, t, pos)[0])(
            jshard_pytree(qp, specs, mesh), jnp.asarray(tokens))
        eng = JEngine(qcfg, JEngineConfig(**ENGINE_FIELDS, quant=mode, tp=4), params=qparams)
        sp = JSamplingParams(temperature=0.0, max_tokens=8)
        hs = [eng.submit(p, sp) for p in PROMPTS]
        while eng.step():
            pass
        ref[mode] = dict(logits=np.asarray(lg),
                         tokens=[h.collect_tokens(timeout=30)[0] for h in hs])
    got = spawn_ranks(workers.tp4_job, 4,
                      args=((MOE_CFG, _np_tree(mparams), token_sets),
                            (dict(name="test-tiny-gqa8"), _np_tree(qparams), tokens),
                            ENGINE_FIELDS, PROMPTS),
                      backend="gloo", env=env, timeout_s=300)
    return ref, got


def test_sharded_moe_matches_jax(tp4):
    ref, got = tp4
    for rank_out in got:
        for a, b in zip(rank_out["moe"], ref["moe"]):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("mode", ["int8", "int8-dynamic"])
def test_int8_tp_engine_matches_jax(tp4, mode):
    ref, got = tp4
    for rank_out in got:
        out = rank_out[mode]
        assert out["tokens"] == ref[mode]["tokens"]
        assert out["wq_cols"] == 8 * 16 // 4          # a quarter of the query columns
        np.testing.assert_allclose(out["logits"], ref[mode]["logits"], rtol=1e-5, atol=1e-5)


def test_sharded_checkpoint_loads_and_provider(tp2):
    ref, got = tp2
    for rank_out in got:
        assert rank_out["loads"] and all(rank_out["loads"].values()), rank_out["loads"]
        assert rank_out["provider_type"] == "LockstepEngine"
        assert rank_out["provider_local_wq"] == 4 * 16 // 2
    assert got[0]["provider_tokens"] == ref["provider_tokens"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_collectives_on_gloo(tp2, dtype):
    """16-bit tensors gather as their bytes (gloo takes no int16) and sum
    in f32, rounded once."""
    _, got = tp2
    xs = [torch.from_numpy(workers.half_rows(r)).to(dtype) for r in range(2)]
    want_sum = (xs[0].float() + xs[1].float()).to(dtype).float().numpy()
    for rank_out in got:
        out = rank_out["halves"][str(dtype)]
        np.testing.assert_array_equal(out["last"], torch.cat(xs, -1).float().numpy())
        np.testing.assert_array_equal(out["first"], torch.cat(xs, 0).float().numpy())
        np.testing.assert_array_equal(out["sum"], want_sum)

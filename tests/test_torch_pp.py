"""Pipeline parallelism in the port against the JAX package, on the CPU:
the analogs of ``tests/test_pipeline.py`` on a dp = 2 x pp = 2 x tp = 2
mesh. The port's ranks are eight spawned processes of one gloo group
(rank functions in ``torch_pp_workers.py``, one job for the module), the
JAX mesh the 8 virtual CPU devices; test-tiny with 4 layers, 4 heads and
4 KV heads, as there.

- f32 ``pipeline_forward`` logits and KV chunks against JAX's
  ``pipeline_forward`` (M = 2) within 2e-4, at M = 1, 2 and 4, which
  agree with each other within 2e-4; bf16 within 5e-2. The batch has 8
  rows, so that each dp shard's 4 split into M = 4 (one row a
  microbatch, as JAX's M = B case).
- ``pipeline_loss_fn``'s loss and every gradient leaf, gathered whole,
  against ``jax.value_and_grad`` of JAX's (each leaf within 1e-4 of its
  largest entry), untied and with tied embeddings (the table feeds stage
  0's lookup and every stage's head); every leaf's slice equal on the
  ranks that hold the same slice (replicated over dp, pp or tp).
- A batch whose microbatches dp does not divide (B = 4, M = 4: one row
  a microbatch, on dp shard 0, shard 1 padding), which the port once
  refused: logits within 1e-3, the loss within 1e-5 and every gradient
  leaf within 1e-4 of its largest entry, against JAX's pipeline on the
  same mesh (the E = 8 MoE edition with drops is
  ``test_torch_ring_mesh.py``'s).
- The schedule's validation messages equal JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pp_workers as workers
from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.parallel import make_mesh as jmake_mesh
from omnia_tpu.parallel import pipeline_forward as jpipeline_forward
from omnia_tpu.parallel import shard_pytree as jshard_pytree
from omnia_tpu.train import trainer as jtrainer
from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.parallel.launch import spawn_ranks
from omnia_tpu_torch.parallel.mesh import Mesh
from omnia_tpu_torch.parallel.pipeline import pipeline_forward
from omnia_tpu_torch.train import trainer

DIMS = dict(dp=2, pp=2, tp=2)
CFG = dict(name="test-tiny", num_layers=4, num_heads=4, num_kv_heads=4)
FWD_TOL = 2e-4
BF16_TOL = 5e-2
GRAD_RTOL = 1e-4
COUNTS = (1, 2, 4)
GRAD_CASES = {"dense": CFG, "tied": dict(CFG, tie_embeddings=True)}
# B = 4 in M = 4 microbatches: a microbatch's one row does not split over dp.
UNEVEN_B, UNEVEN_M, UNEVEN_TOL = 4, 4, 1e-3


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


def _tokens(seed, B, T, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(np.int32)


def _jax_forward(jparams, jcfg, tok, mesh, m=2):
    pos = jnp.broadcast_to(jnp.arange(tok.shape[1], dtype=jnp.int32)[None], tok.shape)
    sharded = jshard_pytree(jparams, jllama.param_specs_pp(jcfg), mesh)
    out = jax.jit(lambda p, t, q: jpipeline_forward(p, jcfg, t, q, mesh, num_microbatches=m))(
        sharded, jnp.asarray(tok), pos)
    return [np.asarray(a, dtype=np.float32) for a in out]


def _jax_loss_grads(jparams, jcfg, tok, mesh, m):
    sharded = jshard_pytree(jparams, jllama.param_specs_pp(jcfg), mesh)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t: jtrainer.pipeline_loss_fn(p, jcfg, t, mesh, m)))(sharded, jnp.asarray(tok))
    return float(loss), _np_tree(g)


@pytest.fixture(scope="module")
def pp_run(devices8):
    """JAX's side on the virtual devices, then the port's eight ranks."""
    mesh = jmake_mesh(**DIMS, devices=devices8)
    jcfg = jget_config(**CFG)
    tok = _tokens(0, 8, 8)
    want, forwards = {}, {}
    for name, dtype, seed in (("f32", jnp.float32, 0), ("bf16", jnp.bfloat16, 2)):
        jparams = jllama.init_params(jcfg, jax.random.key(seed), dtype=dtype)
        want[name] = _jax_forward(jparams, jcfg, tok, mesh)
        forwards[name] = (CFG, _np_tree(jparams), None if name == "f32" else torch.bfloat16,
                          tok, COUNTS if name == "f32" else (2,))
    grads = {}
    tok_g = _tokens(1, 4, 17)
    for name, cfg_kw in GRAD_CASES.items():
        jc = jget_config(**cfg_kw)
        jparams = jllama.init_params(jc, jax.random.key(3), dtype=jnp.float32)
        want[name] = _jax_loss_grads(jparams, jc, tok_g, mesh, 2)
        grads[name] = (cfg_kw, _np_tree(jparams), tok_g, 2)
    jparams = jllama.init_params(jcfg, jax.random.key(4), dtype=jnp.float32)
    tok_u = _tokens(4, UNEVEN_B, 9)
    want["uneven"] = (_jax_forward(jparams, jcfg, tok_u[:, :-1], mesh, UNEVEN_M),
                      _jax_loss_grads(jparams, jcfg, tok_u, mesh, UNEVEN_M))
    forwards["f32_uneven"] = (CFG, _np_tree(jparams), None, tok_u[:, :-1], (UNEVEN_M,))
    grads["uneven"] = (CFG, _np_tree(jparams), tok_u, UNEVEN_M)
    got = spawn_ranks(workers.pp_job, 8, args=(DIMS, forwards, grads), backend="gloo",
                      timeout_s=600)
    return want, got


@pytest.mark.parametrize("m", COUNTS)
def test_pipeline_f32_matches_jax(pp_run, m):
    """Logits [B, T, V] and both KV chunks, gathered over pp and tp, at M
    microbatches against JAX's pipeline_forward at M = 2."""
    want, got = pp_run
    for name, a, b in zip(("logits", "k", "v"), got[0]["f32"][m], want["f32"]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=FWD_TOL, atol=FWD_TOL, err_msg=name)


def test_pipeline_microbatch_counts_agree(pp_run):
    """M is a latency knob, not a math knob: M = 1, 2 and 4 agree."""
    _, got = pp_run
    runs = got[0]["f32"]
    for m in COUNTS[1:]:
        for a, b in zip(runs[COUNTS[0]], runs[m]):
            np.testing.assert_allclose(a, b, rtol=FWD_TOL, atol=FWD_TOL)


def test_pipeline_bf16_matches_jax(pp_run):
    want, got = pp_run
    logits = got[0]["bf16"][2][0]
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, want["bf16"][0], rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_pipeline_loss_gradients_match_jax(pp_run, case):
    """pipeline_loss_fn's loss equals JAX's on every rank, and after
    backward each leaf, gathered whole, is jax.grad's."""
    want, got = pp_run
    jloss, jgrads = want[case]
    ref = dict(trainer.leaves(jgrads))
    for r in got:
        assert abs(r[case]["loss"] - jloss) <= 1e-5 * abs(jloss)
    whole = dict(trainer.leaves(got[0][case]["grads"]))
    assert whole.keys() == ref.keys()
    for path, g in whole.items():
        scale = np.abs(ref[path]).max()
        err = np.abs(g - ref[path]).max()
        assert err <= GRAD_RTOL * scale, f"{path}: {err} of {scale}"


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_replicated_gradients_equal_on_every_rank(pp_run, case):
    """Ranks that hold the same slice of a leaf hold the same gradient:
    norms over tp, embed / final norm / lm_head over pp, everything over
    dp."""
    _, got = pp_run
    workers.assert_replicas_equal(got, case, "local",
                                  llama.param_specs_pp(get_config(**GRAD_CASES[case])))


def _pp_mesh(**dims) -> Mesh:
    """One rank's view of a mesh, without a process group (the checks run
    before any collective)."""
    shape = dict(dict(dp=1, tp=1), **dims)
    return Mesh(shape=shape, coords={a: 0 for a in shape}, comms={})


@pytest.mark.parametrize("m,layers", [(3, 4), (2, 3)])
def test_validation_messages_equal_jax(devices8, m, layers):
    jcfg = jget_config(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    tok = jnp.asarray(_tokens(0, 4, 8))
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32)[None], (4, 8))
    with pytest.raises(ValueError) as jerr:
        jpipeline_forward(jparams, jget_config(**dict(CFG, num_layers=layers)), tok, pos,
                          jmake_mesh(pp=2, devices=devices8), num_microbatches=m)
    ttok = torch.from_numpy(np.array(tok))
    with pytest.raises(ValueError) as terr:
        pipeline_forward({}, get_config(**dict(CFG, num_layers=layers)), ttok,
                         torch.from_numpy(np.array(pos)), _pp_mesh(pp=2), m)
    assert str(terr.value) == str(jerr.value)


def test_a_dp_shard_that_does_not_split_into_microbatches_is_refused(pp_run):
    """Once the port's own refusal, now JAX's schedule: at B = 4, M = 4
    each microbatch's one row lies on dp shard 0 as GSPMD lays it out,
    and logits, both KV chunks, the loss on every rank and every
    gradient leaf equal JAX's pipeline on the same mesh."""
    want, got = pp_run
    forward, (jloss, jgrads) = want["uneven"]
    for name, a, b in zip(("logits", "k", "v"), got[0]["f32_uneven"][UNEVEN_M], forward):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=UNEVEN_TOL, atol=UNEVEN_TOL, err_msg=name)
    for r in got:
        assert abs(r["uneven"]["loss"] - jloss) <= 1e-5 * abs(jloss)
    ref = dict(trainer.leaves(jgrads))
    whole = dict(trainer.leaves(got[0]["uneven"]["grads"]))
    assert whole.keys() == ref.keys()
    for path, g in whole.items():
        scale = np.abs(ref[path]).max()
        err = np.abs(g - ref[path]).max()
        assert err <= GRAD_RTOL * scale, f"{path}: {err} of {scale}"

"""The port's training step and cache-free forward held against the JAX
package on the CPU, f32: the same params (converted with
``params_from_jax``) and the same seeded tokens through
``forward_train``, ``loss_fn`` with its gradients, and AdamW steps
against ``optax.adamw``; a JAX ``TrainState`` carried across and
continued; and a trained state served by the engine with no autograd
graph recorded."""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnia_tpu.models import get_config as jget_config
from omnia_tpu.models import llama as jllama
from omnia_tpu.train import trainer as jtrainer
from omnia_tpu_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from omnia_tpu_torch.models import get_config
from omnia_tpu_torch.models import llama as tllama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.mesh import make_mesh
from omnia_tpu_torch.train import trainer as ttrainer

# f32 on both sides: only summation order differs (measured ~2e-7 on the
# logits, ~7e-7 of each gradient leaf's largest entry).
ATOL = 1e-5
GRAD_RTOL = 1e-5
LR = 1e-2
# AdamW moves a param by lr * m_hat / (sqrt(v_hat) + eps): a gradient
# component near eps (1e-8) turns a summation-order difference of ~1e-9
# into a different fraction of a step, so params are held in units of lr
# (measured 0.007 lr after each of three steps).
PARAM_ATOL = 0.02 * LR

# (config, B, T): test-tiny, and test-tiny-moe below 64 rows of B·T (every
# expert runs) and from 64 on (capacity dispatch).
FORWARDS = [("test-tiny", 2, 12), ("test-tiny-moe", 2, 8), ("test-tiny-moe", 2, 40)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, B, T, vocab=256):
    return np.random.default_rng(seed).integers(1, vocab, (B, T)).astype(np.int32)


def _params(name, seed=0):
    jparams = jllama.init_params(jget_config(name), jax.random.key(seed), dtype=jnp.float32)
    return jparams, params_from_jax(_np_tree(jparams), "cpu")


def _assert_params_close(tparams, jparams, atol):
    ref = dict(ttrainer.leaves(_np_tree(jparams)))
    got = dict(ttrainer.leaves(tparams))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), ref[path], atol=atol, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("name,B,T", FORWARDS)
def test_forward_train_matches_jax(name, B, T):
    jparams, tparams = _params(name)
    tok = _tokens(1, B, T)
    ref = jllama.forward_train(jparams, jget_config(name), jnp.asarray(tok))
    got = tllama.forward_train(tparams, get_config(name), torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == (B, T, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,B,T", [("test-tiny", 2, 13), ("test-tiny-moe", 2, 80)])
def test_loss_and_every_gradient_match_jax(name, B, T):
    """loss_fn and each leaf of its gradient against
    jax.value_and_grad(loss_fn); test-tiny-moe's 2 x 79 rows take
    capacity dispatch."""
    jparams, tparams = _params(name, seed=1)
    tok = _tokens(2, B, T)
    jloss, jgrads = jax.value_and_grad(jtrainer.loss_fn)(jparams, jget_config(name),
                                                         jnp.asarray(tok))
    for _, p in ttrainer.leaves(tparams):
        p.requires_grad_(True)
    loss = ttrainer.loss_fn(tparams, get_config(name), torch.from_numpy(tok))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GRAD_RTOL * abs(float(jloss))
    ref = dict(ttrainer.leaves(_np_tree(jgrads)))
    for path, p in ttrainer.leaves(tparams):
        scale = np.abs(ref[path]).max()
        err = np.abs(p.grad.numpy() - ref[path]).max()
        assert err <= GRAD_RTOL * scale, f"{path}: {err} of {scale}"


def test_three_adamw_steps_match_optax():
    """train_step against the JAX step with optax.adamw(1e-2), from the
    same params and tokens: the losses, and the params after each step."""
    jinit, jstep = jtrainer.make_train_step(jget_config("test-tiny"), optax.adamw(LR))
    jstate = jinit(jax.random.key(0))
    tinit, tstep = ttrainer.make_train_step(get_config("test-tiny"), ttrainer.adamw(LR),
                                            device="cpu")
    tstate = tinit(params=params_from_jax(_np_tree(jstate.params), "cpu"))
    tok = _tokens(3, 4, 13)
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(tok))
        tstate, tloss = tstep(tstate, tok)
        assert abs(float(tloss) - float(jloss)) <= GRAD_RTOL * abs(float(jloss))
        _assert_params_close(tstate.params, jstate.params, PARAM_ATOL)
        assert tstate.step == int(jstate.step) == i + 1


def test_default_optimizer_is_optax_adamw():
    """make_train_step's default equals the JAX trainer's optax.adamw(1e-4),
    with optax's own defaults for the rest (torch's weight decay default
    is 1e-2, optax's 1e-4), over one group that holds every leaf."""
    defaults = {k: v.default for k, v in inspect.signature(optax.adamw).parameters.items()}
    assert defaults["mask"] is None and defaults["eps_root"] == 0.0
    init_fn, _ = ttrainer.make_train_step(get_config("test-tiny"), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    opt = state.opt_state
    assert isinstance(opt, torch.optim.AdamW)
    assert (opt.defaults["lr"], opt.defaults["betas"], opt.defaults["eps"],
            opt.defaults["weight_decay"]) == (
        1e-4, (defaults["b1"], defaults["b2"]), defaults["eps"], defaults["weight_decay"])
    (group,) = opt.param_groups
    assert [id(p) for p in group["params"]] == [id(p) for _, p in ttrainer.leaves(state.params)]
    assert all(p.requires_grad and p.dtype == torch.float32 for p in group["params"])


def test_loss_falls_over_six_steps():
    """The analog of the JAX package's dp x tp training test, on one device."""
    init_fn, train_step = ttrainer.make_train_step(get_config("test-tiny"),
                                                   ttrainer.adamw(LR), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(0, 4, 12))
    state, loss0 = train_step(state, tok)
    for _ in range(5):
        same, loss = train_step(state, tok)
        assert same is state
    assert torch.isfinite(loss) and float(loss) < float(loss0)
    assert state.step == 6


def test_parallel_paths_raise():
    """The mesh paths no longer raise: make_train_step(mesh=) on a one-rank
    mesh (num_microbatches unused without "pp", as in JAX) runs the plain
    trainer's ops, so two steps give its losses and params bit for bit;
    pipeline_loss_fn on that mesh (one stage, two microbatches) gives
    loss_fn's loss. The sharded meshes are held in
    test_torch_train_mesh.py and test_torch_pp.py."""
    cfg = get_config("test-tiny")
    tok = _tokens(8, 4, 13)
    runs = []
    for mesh in (None, make_mesh(world=1, rank=0)):
        init_fn, step = ttrainer.make_train_step(cfg, ttrainer.adamw(LR), mesh=mesh,
                                                 num_microbatches=2, device="cpu")
        state = init_fn(torch.Generator().manual_seed(3))
        losses = [float(step(state, tok)[1]) for _ in range(2)]
        runs.append((losses, state.params))
    (want, ref), (got, params) = runs
    assert got == want
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(ttrainer.leaves(params),
                                                           ttrainer.leaves(ref)))
    one = make_mesh(world=1, rank=0)
    with torch.no_grad():
        a = ttrainer.pipeline_loss_fn(ref, cfg, torch.from_numpy(tok), one, 2)
        b = ttrainer.loss_fn(ref, cfg, torch.from_numpy(tok))
    assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))


def test_jax_train_state_carries_across():
    """Two JAX steps, the state carried across with train_state_from_jax
    (params, optax mu/nu/count → AdamW exp_avg/exp_avg_sq/step), then two
    more steps in each package from there."""
    jinit, jstep = jtrainer.make_train_step(jget_config("test-tiny"), optax.adamw(LR))
    jstate = jinit(jax.random.key(4))
    tok = _tokens(5, 4, 13)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(tok))
    tstate = ttrainer.train_state_from_jax(_np_tree(jstate), "cpu", ttrainer.adamw(LR))
    assert tstate.step == 2
    _, tstep = ttrainer.make_train_step(get_config("test-tiny"), device="cpu")
    for _ in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(tok))
        tstate, tloss = tstep(tstate, tok)
        assert abs(float(tloss) - float(jloss)) <= GRAD_RTOL * abs(float(jloss))
    assert tstate.step == int(jstate.step) == 4
    _assert_params_close(tstate.params, jstate.params, PARAM_ATOL)
    mu = dict(ttrainer.leaves(_np_tree(jstate.opt_state[0].mu)))
    for path, p in ttrainer.leaves(tstate.params):
        st = tstate.opt_state.state[p]
        assert float(st["step"]) == 4
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[path],
                                   atol=GRAD_RTOL * np.abs(mu[path]).max(), rtol=0)


def test_a_trained_state_serves_with_no_graph():
    """An engine fed the trainer's params (requires_grad) serves the greedy
    tokens of an engine over detached copies, and records no graph: its
    KV caches, which every step writes from the params, stay out of
    autograd."""
    cfg = get_config("test-tiny")
    init_fn, train_step = ttrainer.make_train_step(cfg, ttrainer.adamw(LR), device="cpu")
    state, _ = train_step(init_fn(torch.Generator().manual_seed(1)), _tokens(6, 2, 12))
    fields = dict(num_slots=2, max_seq=64, prefill_buckets=(16,), dtype="float32",
                  max_sessions=0)
    detached = jax.tree.map(lambda t: t.detach().clone(), state.params)
    streams = []
    for params in (state.params, detached):
        eng = InferenceEngine(cfg, EngineConfig(**fields), params=params, seed=0, device="cpu")
        handles = [eng.submit(list(p), SamplingParams(temperature=0.0, max_tokens=8))
                   for p in _tokens(7, 2, 9)]
        while eng.step():
            pass
        streams.append([h.collect_tokens(timeout=10)[0] for h in handles])
        for c in (eng._ck, eng._cv):
            assert not c.requires_grad and c.grad_fn is None
        assert eng._tokens.grad_fn is None
    assert all(p.requires_grad for _, p in ttrainer.leaves(state.params))
    assert streams[0] == streams[1] and all(len(s) == 8 for s in streams[0])

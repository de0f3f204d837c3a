"""Rank functions of the port's pipeline and sharded-training tests
(``test_torch_pp.py``, ``test_torch_train_mesh.py``), run by
``parallel.launch.spawn_ranks`` in processes of their own. Imports torch
and the port only: a spawned rank never imports jax.

Each returns, per case, what rank 0 gathers whole and what every rank
holds itself (``local``), so that the test can hold the whole against
the JAX package and the ranks' slices against each other: a leaf that
two ranks hold the same slice of must be equal on both."""

from __future__ import annotations

import numpy as np
import torch

from omnia_tpu_torch.models import get_config, llama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.mesh import make_mesh
from omnia_tpu_torch.parallel.pipeline import pipeline_forward
from omnia_tpu_torch.parallel.sharding import P, gather_pytree
from omnia_tpu_torch.train import trainer

# A stage's KV chunk [L / pp, B, T, Hkv / tp, D] (gathered over dp by
# pipeline_forward).
KV_SPEC = P("pp", None, None, "tp", None)
# The NCCL case: test-tiny as tests/test_pipeline.py widens it.
NCCL_CFG = dict(name="test-tiny", num_layers=4, num_heads=4, num_kv_heads=4)


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy: the optimizer updates the params in place."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _grads(params) -> dict:
    return _tree(params, lambda p: p.grad)


def _held(rank: int, tree, specs, mesh) -> dict:
    """(rank 0: the tree gathered whole, numpy; None elsewhere; every rank:
    its own slices, numpy). Gathering is a collective: every rank calls."""
    whole = gather_pytree(tree, specs, mesh)
    local = dict((path, _np(t)) for path, t in trainer.leaves(tree))
    return (_tree(whole, _np) if rank == 0 else None), local


def assert_replicas_equal(got: list, case: str, key: str, specs) -> None:
    """Ranks that hold the same slice of a leaf (the same coordinates on
    the axes its spec splits it over) hold the same bytes of ``key``."""
    for path, spec in trainer.leaves(specs):
        groups: dict = {}
        for r in got:
            where = tuple(r["coords"].get(axis, 0) for axis in spec if axis is not None)
            groups.setdefault(where, []).append(r[case][key][path])
        assert all(len(g) > 1 for g in groups.values()), path
        for g in groups.values():
            for other in g[1:]:
                np.testing.assert_array_equal(other, g[0], err_msg=path)


def pp_job(rank: int, dims: dict, forwards: dict, grads: dict) -> dict:
    """On ``make_mesh(**dims)``: (a) per forward case, ``pipeline_forward``'s
    logits and its KV chunks gathered whole, at each microbatch count; (b)
    per gradient case, ``pipeline_loss_fn``'s loss and its gradient."""
    torch.set_num_threads(1)
    mesh = make_mesh(**dims)
    out = {"coords": mesh.coords}
    for name, (cfg_kw, tree, dtype, tokens, counts) in forwards.items():
        cfg = get_config(**cfg_kw)
        params = params_from_jax(tree, "cpu", dtype, mesh=mesh, cfg=cfg)
        tok = torch.from_numpy(tokens)
        pos = torch.arange(tok.shape[1], dtype=torch.int32).expand_as(tok)
        runs = {}
        for m in counts:
            with torch.no_grad():
                logits, k, v = pipeline_forward(params, cfg, tok, pos, mesh, m)
            k, v = gather_pytree((k, v), (KV_SPEC, KV_SPEC), mesh)
            runs[m] = (_np(logits), _np(k), _np(v)) if rank == 0 else None
        out[name] = runs
    for name, (cfg_kw, tree, tokens, m) in grads.items():
        cfg = get_config(**cfg_kw)
        mesh_specs = llama.mesh_param_specs(cfg, mesh)
        params = params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg)
        for _, p in trainer.leaves(params):
            p.requires_grad_(True)
        loss = trainer.pipeline_loss_fn(params, cfg, torch.from_numpy(tokens), mesh, m)
        loss.backward()
        whole, local = _held(rank, _grads(params), mesh_specs, mesh)
        out[name] = dict(loss=float(loss), grads=whole, local=local)
    return out


def train_job(rank: int, dims: dict, steps: dict, grads: dict) -> dict:
    """On ``make_mesh(**dims)``: (a) per step case, a JAX state carried over
    with ``train_state_from_jax(mesh=)`` and stepped by
    ``make_train_step(mesh=, num_microbatches=)``: each step's loss and
    params gathered whole, and the last step's slices; (b) per gradient
    case, one ``make_train_step(mesh=)`` step from the given params: its
    loss and gradient (``loss_fn(mesh=)``'s)."""
    torch.set_num_threads(1)
    mesh = make_mesh(**dims)
    out = {"coords": mesh.coords}
    for name, (cfg_kw, state, lr, tokens, m, n) in steps.items():
        cfg = get_config(**cfg_kw)
        specs = llama.mesh_param_specs(cfg, mesh)
        st = trainer.train_state_from_jax(state, "cpu", trainer.adamw(lr), mesh=mesh, cfg=cfg)
        _, step = trainer.make_train_step(cfg, trainer.adamw(lr), mesh=mesh, num_microbatches=m,
                                          device="cpu")
        losses, params = [], []
        for _ in range(n):
            st, loss = step(st, tokens)
            losses.append(float(loss))
            whole, local = _held(rank, _tree(st.params, torch.Tensor.detach), specs, mesh)
            params.append(whole)
        out[name] = dict(losses=losses, params=params, local=local, step=st.step)
    for name, (cfg_kw, tree, tokens) in grads.items():
        cfg = get_config(**cfg_kw)
        init_fn, step = trainer.make_train_step(cfg, mesh=mesh, device="cpu")
        state, loss = step(init_fn(params=params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg)),
                           tokens)
        whole, local = _held(rank, _grads(state.params), llama.param_specs(cfg), mesh)
        out[name] = dict(loss=float(loss), grads=whole, local=local)
    return out


# -- test_torch_nccl_cuda.py -----------------------------------------------


def nccl_train_job(rank: int) -> dict:
    """The NCCL route of the sharded trainer, one rank per card: one
    train_step at pp = 2 x tp = 2 (NCCL_CFG, f32, drawn by init_fn from one
    seed on each rank's card, M = 2), its gradient gathered onto rank 0,
    which also takes the step on one rank from the same seed."""
    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    mesh = make_mesh(pp=2, tp=2)
    cfg = get_config(**NCCL_CFG)
    tok = np.random.default_rng(5).integers(1, cfg.vocab_size, (4, 17)).astype(np.int32)
    init_fn, step = trainer.make_train_step(cfg, mesh=mesh, num_microbatches=2)
    state, loss = step(init_fn(torch.Generator(device=dev).manual_seed(5)), tok)
    whole, _ = _held(rank, _grads(state.params), llama.param_specs_pp(cfg), mesh)
    out = dict(backend=mesh.comm("pp").backend, device=str(state.params["embed"].device),
               loss=float(loss), grads=whole)
    if rank == 0:
        init_fn, step = trainer.make_train_step(cfg)
        ref, ref_loss = step(init_fn(torch.Generator(device=dev).manual_seed(5)), tok)
        out.update(loss_tp1=float(ref_loss), grads_tp1=_tree(_grads(ref.params), _np))
    return out

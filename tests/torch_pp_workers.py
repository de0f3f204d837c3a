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


# llama3-8b trained at pp = 2 x tp = 2 over NCCL: B = 4, T = 513 (512
# input tokens a row), two microbatches; (1) its full width cut to 2
# layers, f32, TF32 off, one step against one card's; (2) all 32 layers
# in bf16, NCCL_8B_TRAIN_STEPS steps of the default AdamW on one batch.
NCCL_8B_TRAIN_MESH = dict(pp=2, tp=2)
NCCL_8B_TRAIN_BATCH, NCCL_8B_TRAIN_M, NCCL_8B_TRAIN_SEED = (4, 513), 2, 14
NCCL_8B_TRAIN_CHECK_LAYERS, NCCL_8B_TRAIN_STEPS = 2, 5


def _timed_comms(mesh, spans: list):
    """A context in which every collective of ``mesh``'s Comms is bracketed
    by CUDA events on the calling stream (the backward's too, on
    autograd's thread): (axis, op, bytes, start, end) go to ``spans``. A
    NCCL call is asynchronous, so ``Comm`` keeps no seconds of its own;
    the events give its span on the stream that waits for it, the wait
    for the slowest peer included."""
    import contextlib

    from omnia_tpu_torch.parallel.collectives import Comm

    axes = {id(mesh.comm(a)): a for a in mesh.axis_names if mesh.comm(a) is not None}
    start, tally = Comm._start, Comm._tally

    def timed_start(self, x):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_tally(self, op, nbytes, t0):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        if id(self) in axes:
            spans.append((axes[id(self)], op, nbytes, t0, e))
        tally(self, op, nbytes, None)

    @contextlib.contextmanager
    def ctx():
        Comm._start, Comm._tally = timed_start, timed_tally
        try:
            yield spans
        finally:
            Comm._start, Comm._tally = start, tally

    return ctx()


def _span_totals(spans: list) -> dict:
    """{axis: {op: {"calls", "bytes", "s"}}} of synchronized spans."""
    out: dict = {}
    for axis, op, nbytes, e0, e1 in spans:
        st = out.setdefault(axis, {}).setdefault(op, {"calls": 0, "bytes": 0, "s": 0.0})
        st["calls"] += 1
        st["bytes"] += nbytes
        st["s"] += e0.elapsed_time(e1) / 1e3
    return out


def _state_bytes(state) -> dict:
    """This rank's params, gradients and AdamW moments, in bytes."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    params = [p for _, p in trainer.leaves(state.params)]
    opt = state.opt_state.state
    return dict(params=nbytes(params), grads=nbytes(p.grad for p in params),
                moments=nbytes(opt[p][k] for p in params for k in ("exp_avg", "exp_avg_sq")))


def _train_8b_check(rank: int, dev, mesh, tok: np.ndarray) -> dict:
    """(1): one f32 step of llama3-8b's width cut to
    NCCL_8B_TRAIN_CHECK_LAYERS layers, drawn by init_fn from one seed on
    each rank (the whole tree's values, cut), at pp = 2 x tp = 2; its
    gradient gathered whole on every rank; rank 0 takes the step on one
    card from the same seed and holds each leaf against it there: (the
    largest difference, the one-card leaf's largest entry) per leaf."""
    cfg = get_config("llama3-8b", num_layers=NCCL_8B_TRAIN_CHECK_LAYERS)
    init_fn, step = trainer.make_train_step(cfg, mesh=mesh, num_microbatches=NCCL_8B_TRAIN_M)
    state, loss = step(init_fn(torch.Generator(device=dev).manual_seed(NCCL_8B_TRAIN_SEED)), tok)
    whole = gather_pytree(_grads(state.params), llama.param_specs_pp(cfg), mesh)
    out = dict(loss=float(loss))
    del state
    if rank == 0:
        init_fn, step = trainer.make_train_step(cfg)
        ref, ref_loss = step(init_fn(torch.Generator(device=dev).manual_seed(NCCL_8B_TRAIN_SEED)),
                             tok)
        grads = dict(trainer.leaves(whole))
        out.update(loss_tp1=float(ref_loss), grad_err={
            path: (float((grads[path] - p.grad).abs().max()), float(p.grad.abs().max()))
            for path, p in trainer.leaves(ref.params)})
        del ref
    del whole
    return out


def nccl_train_8b_job(rank: int) -> dict:
    """llama3-8b trained at pp = 2 x tp = 2 over NCCL, one rank per card:
    (1) ``_train_8b_check``; (2) the whole model in bf16 from init_fn (each
    leaf drawn whole and cut), NCCL_8B_TRAIN_STEPS steps on one fixed
    batch: each step's loss, ms (host clock around a synchronized step)
    and collectives (``_timed_comms``), this rank's state bytes, the init's
    peak and the steps' peak."""
    import gc
    import time

    from omnia_tpu_torch.parallel.distributed import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    mesh = make_mesh(**NCCL_8B_TRAIN_MESH)
    cfg = get_config("llama3-8b")
    tok = np.random.default_rng(NCCL_8B_TRAIN_SEED).integers(
        1, cfg.vocab_size, NCCL_8B_TRAIN_BATCH).astype(np.int32)
    out = dict(rank=rank, backend=mesh.comm("pp").backend, coords=mesh.coords,
               check=_train_8b_check(rank, dev, mesh, tok), steps=[])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step = trainer.make_train_step(cfg, mesh=mesh, num_microbatches=NCCL_8B_TRAIN_M)
    t0 = time.monotonic()
    state = init_fn(torch.Generator(device=dev).manual_seed(NCCL_8B_TRAIN_SEED),
                    dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out.update(init_s=time.monotonic() - t0, init_peak_bytes=torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(tok).to(dev)
    for _ in range(NCCL_8B_TRAIN_STEPS):
        spans: list = []
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with _timed_comms(mesh, spans):
            state, loss = step(state, tokens)
            torch.cuda.synchronize()
        out["steps"].append(dict(loss=float(loss), ms=(time.monotonic() - t0) * 1e3,
                                 collectives=_span_totals(spans)))
    out.update(state_bytes=_state_bytes(state), peak_bytes=torch.cuda.max_memory_allocated(),
               tokens_per_step=NCCL_8B_TRAIN_BATCH[0] * (NCCL_8B_TRAIN_BATCH[1] - 1))
    return out

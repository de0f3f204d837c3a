"""Training step for the port's model family (port of
``omnia_tpu/train/trainer.py``).

- Next-token cross-entropy over ``llama.forward_train`` (log-softmax in
  f32) and an AdamW update, on one device or over a mesh.
- The default optimizer is ``optax.adamw(1e-4)``: AdamW with optax's
  betas, eps and weight decay (1e-4; ``torch.optim.AdamW``'s own default
  is 1e-2), the decay applied to every leaf, norms included, as optax's
  default mask does.
- JAX's jitted step donates its state and returns a new one; here
  ``train_step`` updates the params and the optimizer's moments in place
  and returns the same state.
- Precision: params keep the dtype ``init_fn`` drew them in (f32 by
  default, as in JAX). The trainer leaves
  ``torch.backends.cuda.matmul.allow_tf32`` at PyTorch's default (False),
  so an f32 product on the card is f32.
- **On a mesh** every rank holds its slice of the tree by
  ``llama.param_specs`` (tp over heads, FFN, experts and vocab), or by
  ``param_specs_pp`` when the mesh has "pp" (the layers split over the
  stages; the step then runs ``pipeline_loss_fn``, the GPipe schedule of
  ``parallel/pipeline.py``). Each rank takes the global batch and runs
  its dp shard's contiguous rows, under pp its block of each microbatch
  (an MoE layer branching, sizing its capacity and dropping over the
  whole batch or microbatch, as GSPMD's does). dp need not divide the
  rows: a shard holds GSPMD's ceil(rows / dp) block, padded where it is
  short, and the padding rows drop out of the MoE's slots and of the
  loss, which is the sum of every shard's token NLLs over the batch's
  token count, on every rank. The collectives carry their transposes, so after
  ``backward`` each sliced leaf holds its slice of the global gradient
  and each replicated leaf (over tp, pp or dp) the same global gradient
  on every rank. AdamW is elementwise, and optax's default has no
  clipping, so the sharded update is JAX's global one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from omnia_tpu_torch import resolve_device
from omnia_tpu_torch.models import ModelConfig, llama
from omnia_tpu_torch.models.convert import params_from_jax
from omnia_tpu_torch.parallel.collectives import all_reduce_sum
from omnia_tpu_torch.parallel.pipeline import (check_schedule, dp_params, dp_rows, real_rows,
                                               shard_rows, stage_forward)

# A factory over the parameter list, e.g. ``adamw(1e-4)``.
OptimizerFactory = Callable[[list], torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: torch.optim.Optimizer
    step: int


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """``optax.adamw``'s arguments and defaults, as a factory over a
    parameter list: one group, so the decay covers every leaf."""
    def make(params: list) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)

    return make


def leaves(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of a nested dict, depth first in the dict's order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, f"{path}/{k}")]
    return [(path, tree)]


def _nll(logits, tokens):
    """Each next token's NLL [B, T - 1], the log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]


def _global_mean(nll, count: int, mesh):
    """The whole batch's mean NLL on every rank: the sum of this dp
    shard's real rows' NLLs, summed over dp, over the batch's ``count``
    tokens; each shard's gradient is its share."""
    return all_reduce_sum(nll.sum(), mesh.comm("dp")) / count


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy. tokens: int [B, T]. On a mesh
    (without "pp") ``params`` is this rank's slice by ``param_specs``,
    tokens the global batch, and the rank runs its dp shard's rows
    (``pipeline.dp_rows``: GSPMD's blocks, so dp need not divide B)."""
    if mesh is None:
        return _nll(llama.forward_train(params, cfg, tokens[:, :-1]), tokens).mean()
    B, T = tokens.shape
    local = shard_rows(tokens, mesh, 1)
    logits = llama.forward_train(dp_params(params, mesh), cfg, local[:, :-1], mesh.comm("tp"),
                                 dp_rows(B, mesh)[2])
    return _global_mean(real_rows(_nll(logits, local), mesh, 1, B), B * (T - 1), mesh)


def pipeline_loss_fn(params, cfg: ModelConfig, tokens, mesh, num_microbatches=None):
    """``loss_fn`` through the GPipe schedule over the mesh's "pp" axis
    (``parallel/pipeline.py``): the same mean, ``params`` this rank's
    slice by ``param_specs_pp``, tokens int [B, T] the global batch."""
    B, T = tokens.shape
    M = check_schedule(B, cfg, mesh, num_microbatches)
    local = shard_rows(tokens, mesh, M)
    params = dp_params(params, mesh)
    pos = torch.arange(T - 1, dtype=torch.int32, device=tokens.device).expand(local.shape[0], -1)
    out, _, _ = stage_forward(params, cfg, local[:, :-1], pos, mesh, M, B, keep_kv=False)
    tp = mesh.comm("tp")
    logits = llama.gather_logits(llama._logits(params, cfg, out, tp), tp)
    return _global_mean(real_rows(_nll(logits, local), mesh, M, B // M), B * (T - 1), mesh)


def _start(params: dict, optimizer: OptimizerFactory, step: int = 0) -> TrainState:
    for _, p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer([p for _, p in leaves(params)]),
                      step=step)


def make_train_step(cfg: ModelConfig, optimizer: Optional[OptimizerFactory] = None,
                    mesh=None, num_microbatches: Optional[int] = None, device=None):
    """Returns (init_fn, train_step).

    init_fn(generator, dtype=torch.float32, params=None) -> TrainState:
    params drawn from ``generator`` on the device (``resolve_device``), or
    the given params, which then become the state's own leaves. On a
    ``mesh`` the drawn tree is cut to this rank's slice
    (``llama.mesh_param_specs``: the whole tree's values), and given
    params must be that slice already.
    train_step(state, tokens) -> (state, loss): one AdamW step in place;
    the same state comes back with ``step`` advanced, and each leaf's
    ``.grad`` holds the step's gradient until the next step. On a mesh
    every rank passes the global batch and gets the global mean loss; a
    mesh with "pp" runs ``pipeline_loss_fn`` with ``num_microbatches``
    (default: the pp size), which is unused otherwise, as in JAX."""
    optimizer = optimizer or adamw(1e-4)
    dev = resolve_device(device)
    pipelined = mesh is not None and "pp" in mesh.axis_names

    def init_fn(generator: Optional[torch.Generator] = None, dtype=torch.float32,
                params: Optional[dict] = None) -> TrainState:
        if params is None:
            params = llama.init_params(cfg, generator, dev, dtype=dtype, mesh=mesh)
        return _start(params, optimizer)

    def train_step(state: TrainState, tokens):
        tokens = torch.as_tensor(tokens, device=state.params["embed"].device)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            if pipelined:
                loss = pipeline_loss_fn(state.params, cfg, tokens, mesh, num_microbatches)
            else:
                loss = loss_fn(state.params, cfg, tokens, mesh)
            loss.backward()
        opt.step()
        state.step += 1
        return state, loss.detach()

    return init_fn, train_step


def train_state_from_jax(jax_state, device, optimizer: Optional[OptimizerFactory] = None,
                         mesh=None, cfg: Optional[ModelConfig] = None) -> TrainState:
    """A JAX ``TrainState`` as numpy arrays (``jax.tree.map(np.asarray,
    state)``, its optimizer ``optax.adamw``) → the port's TrainState on
    ``device``: the params, and AdamW's per-leaf ``exp_avg`` (optax's
    ``mu``), ``exp_avg_sq`` (``nu``) and ``step`` (``count``).
    ``optimizer`` must be the factory of the JAX state's hyperparameters
    (default ``adamw(1e-4)``, as optax's). With a ``mesh`` (and the
    model's ``cfg``) the params and both moments are cut to this rank's
    slice, by ``llama.mesh_param_specs``."""
    def convert(tree):
        return params_from_jax(tree, device, mesh=mesh, cfg=cfg)

    state = _start(convert(jax_state.params), optimizer or adamw(1e-4),
                   step=int(np.asarray(jax_state.step)))
    adam = next(s for s in jax_state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    dtypes = {path: p.dtype for path, p in leaves(state.params)}
    mu = {path: t.to(dtypes[path]) for path, t in leaves(convert(adam.mu))}
    nu = {path: t.to(dtypes[path]) for path, t in leaves(convert(adam.nu))}
    count = float(np.asarray(adam.count))
    sd = state.opt_state.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(count),
            "exp_avg": mu[path], "exp_avg_sq": nu[path]}
        for i, (path, p) in enumerate(leaves(state.params))
    }
    state.opt_state.load_state_dict(sd)
    return state

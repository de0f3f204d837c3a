"""Training step for the port's model family (port of
``omnia_tpu/train/trainer.py``).

- Next-token cross-entropy over ``llama.forward_train`` (log-softmax in
  f32) and an AdamW update, on one device.
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
- The dp/tp mesh and the pp-microbatched pipeline are ROADMAP A13:
  ``mesh=``, ``num_microbatches=`` and ``pipeline_loss_fn`` raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from omnia_tpu_torch import resolve_device
from omnia_tpu_torch.models import ModelConfig, llama
from omnia_tpu_torch.models.convert import params_from_jax

# A factory over the parameter list, e.g. ``adamw(1e-4)``.
OptimizerFactory = Callable[[list], torch.optim.Optimizer]

_NOT_PORTED = "is not ported to omnia_tpu_torch yet (ROADMAP A13: the parallel paths)"


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


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy. tokens: int [B, T]."""
    logits = llama.forward_train(params, cfg, tokens[:, :-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


def pipeline_loss_fn(params, cfg: ModelConfig, tokens, mesh, num_microbatches=None):
    """The pp-microbatched loss of the JAX package."""
    raise NotImplementedError(f"pipeline_loss_fn {_NOT_PORTED}")


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
    the given params, which then become the state's own leaves.
    train_step(state, tokens) -> (state, loss): one AdamW step in place;
    the same state comes back with ``step`` advanced, and each leaf's
    ``.grad`` holds the step's gradient until the next step."""
    if mesh is not None or num_microbatches is not None:
        raise NotImplementedError(f"make_train_step(mesh=, num_microbatches=) {_NOT_PORTED}")
    optimizer = optimizer or adamw(1e-4)
    dev = resolve_device(device)

    def init_fn(generator: Optional[torch.Generator] = None, dtype=torch.float32,
                params: Optional[dict] = None) -> TrainState:
        if params is None:
            params = llama.init_params(cfg, generator, dev, dtype=dtype)
        return _start(params, optimizer)

    def train_step(state: TrainState, tokens):
        tokens = torch.as_tensor(tokens, device=state.params["embed"].device)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(state.params, cfg, tokens)
            loss.backward()
        opt.step()
        state.step += 1
        return state, loss.detach()

    return init_fn, train_step


def train_state_from_jax(jax_state, device,
                         optimizer: Optional[OptimizerFactory] = None) -> TrainState:
    """A JAX ``TrainState`` as numpy arrays (``jax.tree.map(np.asarray,
    state)``, its optimizer ``optax.adamw``) → the port's TrainState on
    ``device``: the params, and AdamW's per-leaf ``exp_avg`` (optax's
    ``mu``), ``exp_avg_sq`` (``nu``) and ``step`` (``count``).
    ``optimizer`` must be the factory of the JAX state's hyperparameters
    (default ``adamw(1e-4)``, as optax's)."""
    state = _start(params_from_jax(jax_state.params, device), optimizer or adamw(1e-4),
                   step=int(np.asarray(jax_state.step)))
    adam = next(s for s in jax_state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    mu, nu = dict(leaves(adam.mu)), dict(leaves(adam.nu))
    count = float(np.asarray(adam.count))
    sd = state.opt_state.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(count),
            "exp_avg": params_from_jax(mu[path], device, p.dtype),
            "exp_avg_sq": params_from_jax(nu[path], device, p.dtype)}
        for i, (path, p) in enumerate(leaves(state.params))
    }
    state.opt_state.load_state_dict(sd)
    return state

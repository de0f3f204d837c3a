"""Mixture-of-experts routing and capacity dispatch (port of
``omnia_tpu/ops/moe.py``).

Two implementations of one Mixtral MLP, chosen by shape in ``moe_mlp``:

- ``moe_dense``: every expert runs on every token and the top-k-masked
  router weights combine them. Nothing drops; ~E/k extra products. The
  decode step's path (a handful of slots).
- ``moe_dispatch``: GShard-style capacity dispatch, sort-based: the N·K
  (token, expert) assignments are sorted by expert, tokens are gathered
  into an [E, C, d] buffer, each expert's MLP is one batched product,
  and the results are added back per token. An assignment past its
  expert's capacity C = ceil(N·K·capacity_factor / E) contributes zero.

The branch and the capacity depend on (B, T), so a caller that wants the
JAX package's tokens calls with its shapes and its pad rows.

- **Ties** in the router's top-k go to the lower expert index, as
  ``jax.lax.top_k`` does: the top K come from a stable descending sort.
- **The assignment sort** is stable (``torch.argsort(stable=True)``), as
  JAX's ``argsort`` is, so within an expert tokens keep their order and
  the first ones in the flattened batch take the capacity.
- **Expert weights are read in place**: ``[E, D, F]`` is the batch of a
  matmul, never permuted, so a step copies no weight.
- Products and the combine run in the activation dtype; the router's
  softmax in f32.
- **Expert parallelism** (``comm``, the "tp" axis): each rank holds
  E / tp experts (``[E/tp, D, F]``, rank r the r-th run) and the router
  whole. Routing and the capacity C (over the global E) are computed on
  every rank alike, so the kept and dropped assignments are the
  single-device ones; each rank runs only its experts' rows and the
  partial outputs are summed over the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from omnia_tpu_torch.parallel.collectives import Comm, all_reduce_sum


def route_sparse(h: torch.Tensor, router_w: torch.Tensor, num_experts_per_tok: int):
    """Router: h [..., d] × router_w [d, E] → (top_w f32, top_i int64), each
    [..., K]: softmax over all experts in f32, the top K kept (the lower
    index first among equal probabilities) and renormalized to sum 1."""
    logits = torch.matmul(h, router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :num_experts_per_tok], top_i[..., :num_experts_per_tok]
    return top_w / top_w.sum(dim=-1, keepdim=True), top_i


def route_topk(h: torch.Tensor, router_w: torch.Tensor, num_experts_per_tok: int):
    """Dense combine weights [..., E] (f32): top-k renormalized, zero
    elsewhere."""
    top_w, top_i = route_sparse(h, router_w, num_experts_per_tok)
    combine = torch.zeros(top_w.shape[:-1] + (router_w.shape[-1],),
                          dtype=top_w.dtype, device=top_w.device)
    return combine.scatter_(-1, top_i, top_w)


def _experts(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Each expert's SwiGLU MLP on its own rows: x [E or 1, M, d] → [E, M, d]."""
    gate = torch.matmul(x, p["wg"])
    up = torch.matmul(x, p["wu"])
    return torch.matmul(F.silu(gate) * up, p["wd"])


def _local_experts(p: dict, comm: Optional[Comm]) -> tuple[int, int]:
    """(first, count) of the experts this rank holds."""
    n = p["wg"].shape[0]
    return (0 if comm is None else comm.index * n), n


def moe_dense(h: torch.Tensor, p: dict, num_experts_per_tok: int,
              comm: Optional[Comm] = None) -> torch.Tensor:
    """All-expert MoE: exact, no drops. h [B, T, d] → [B, T, d]."""
    B, T, d = h.shape
    combine = route_topk(h, p["router"], num_experts_per_tok).reshape(B * T, -1)  # [BT, E]
    if comm is not None:
        e0, n = _local_experts(p, comm)
        combine = combine[:, e0:e0 + n]
    expert_out = _experts(h.reshape(1, B * T, d), p)                     # [E, BT, d]
    out = torch.einsum("ne,end->nd", combine.to(h.dtype), expert_out)
    return all_reduce_sum(out, comm).reshape(B, T, d)


def moe_dispatch(h: torch.Tensor, p: dict, num_experts_per_tok: int,
                 capacity_factor: float = 2.0, comm: Optional[Comm] = None) -> torch.Tensor:
    """Capacity-dispatched MoE. h [B, T, d] → [B, T, d]. Assignments past
    an expert's capacity land in a trash row of the buffer and contribute
    zero; under ``comm`` so do those of another rank's experts."""
    B, T, d = h.shape
    E = p["router"].shape[-1]
    K = num_experts_per_tok
    N = B * T
    capacity = max(1, int(-(-N * K * capacity_factor // E)))  # ceil
    NK = N * K
    dev = h.device

    flat = h.reshape(N, d)
    top_w, top_i = route_sparse(flat, p["router"], K)                    # [N, K]
    e_flat = top_i.reshape(NK)                                           # token-major
    w_flat = top_w.reshape(NK)
    tok_of = torch.arange(N, device=dev).repeat_interleave(K)

    order = torch.argsort(e_flat, stable=True)
    e_s, w_s, t_s = e_flat[order], w_flat[order], tok_of[order]
    # bincount(minlength=E) without its host sync on the output size.
    counts = torch.zeros(E, dtype=e_flat.dtype, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts                            # first row per expert
    pos = torch.arange(NK, device=dev) - starts[e_s]
    keep = pos < capacity
    dest = torch.where(keep, e_s * capacity + pos, E * capacity)

    xs = torch.zeros((E * capacity + 1, d), dtype=flat.dtype, device=dev)
    xs[dest] = flat[t_s]              # only the trash row receives duplicates
    e0, n = _local_experts(p, comm)
    lo, hi = e0 * capacity, (e0 + n) * capacity
    ys = _experts(xs[lo:hi].view(n, capacity, d), p)                     # [E/tp, C, d]
    if comm is not None:
        keep = keep & (e_s >= e0) & (e_s < e0 + n)

    contrib = ys.reshape(n * capacity, d)[(dest - lo).clamp(0, n * capacity - 1)]
    contrib = contrib * (w_s * keep).to(flat.dtype)[:, None]
    out = torch.zeros((N, d), dtype=flat.dtype, device=dev).index_add_(0, t_s, contrib)
    return all_reduce_sum(out, comm).reshape(B, T, d)


# Below this many tokens the dense path is both faster (no dispatch
# bookkeeping) and exact (no drops); above it, dispatched products win.
DISPATCH_MIN_TOKENS = 64


def moe_mlp(h: torch.Tensor, p: dict, num_experts_per_tok: int,
            capacity_factor: float = 2.0, comm: Optional[Comm] = None) -> torch.Tensor:
    """Dense below DISPATCH_MIN_TOKENS rows (B·T), dispatched from it on."""
    B, T, _ = h.shape
    if B * T < DISPATCH_MIN_TOKENS:
        return moe_dense(h, p, num_experts_per_tok, comm)
    return moe_dispatch(h, p, num_experts_per_tok, capacity_factor, comm=comm)

"""Pipeline parallelism: the GPipe schedule over the mesh's "pp" axis
(port of ``omnia_tpu/parallel/pipeline.py``).

Each pp stage holds L / pp contiguous layers (``llama.param_specs_pp``
splits the stacked layer axis, so a stage's tree is the model's tree with
fewer layers). A batch is cut into M microbatches and run in M + S - 1
ticks: at tick t stage s runs microbatch t - s through its layers and
keeps that microbatch's KV, then sends its output to stage s + 1
(``collectives.stage_send``: JAX's ``ppermute`` with pairs (i, i + 1) and
no S - 1 -> 0 edge; the send and the receive of a tick posted together).
The last stage's outputs are broadcast, as bytes, to every stage, where
the JAX package reduces them in f32 (exact either way: the other stages
add zeros), and every rank computes the head.

tp runs inside each stage as in ``llama._layer``. Under dp each
microbatch is JAX's (rows m * B / M to (m + 1) * B / M of the batch), and
each shard takes its contiguous block of every microbatch
(``shard_rows``), so that an MoE layer, which dispatches over a
microbatch's rows, sees one GSPMD microbatch split in shard order and
takes the whole microbatch's branch, capacity and drops (``ops/moe.py``,
``dp``); what the stages give back is gathered into batch order
(``gather_rows``). A microbatch of B / M rows that dp does not divide is
laid out as GSPMD lays it: each shard a block of ceil(B / M / dp) rows,
the last shards fewer or none (``dp_rows``). Each shard's block is
padded to that size, so that every rank's collectives keep one size; the
padding rows take no expert slot, and the loss and the gathered outputs
leave them out.

**Gradients.** The schedule is differentiable, as JAX's ``lax.scan`` is:
the sends carry their transposes, and a scalar token, threaded through
the embedding lookup, every send and the output broadcast, makes each
rank's backward reach every send of its stage in one order (last tick
first), even a stage whose output the loss never reads. Only stage 0
looks the tokens up; going back, the lookup's gradient is broadcast from
stage 0 over "pp", so every stage's ``embed`` gets it once, and the head's
part, which every stage computes alike, once too.
"""

from __future__ import annotations

from typing import Optional

import torch

from omnia_tpu_torch.models.config import ModelConfig
from omnia_tpu_torch.parallel.collectives import (Comm, ShardRows, all_gather, broadcast, copy_in,
                                                  stage_send)


class _Lookup(torch.autograd.Function):
    """Stage 0's embedding lookup (vocab-parallel under tp: a SUM of each
    rank's rows), an empty tensor on the other stages. Backward: stage 0's
    gradient of the looked-up rows, broadcast over "pp", lands on this
    rank's rows of the table on every stage."""

    @staticmethod
    def forward(ctx, token, table, tokens, shape, tp: Optional[Comm], pp: Comm):
        from omnia_tpu_torch.models.llama import _lookup

        ctx.save_for_backward(tokens)
        ctx.tp, ctx.pp, ctx.shape, ctx.table = tp, pp, shape, (table.shape, table.dtype)
        rows = table.new_empty(0) if pp.index else _lookup(table, tokens, tp)
        return token.clone(), rows

    @staticmethod
    def backward(ctx, g_token, g_rows):
        from omnia_tpu_torch.models.llama import _vocab_rows

        (tokens,) = ctx.saved_tensors
        (V, D), dtype = ctx.table
        if ctx.pp.index:
            g_rows = torch.empty(ctx.shape, dtype=dtype, device=tokens.device)
        g_rows = ctx.pp.broadcast(g_rows.contiguous(), 0, "broadcast_backward").reshape(-1, D)
        g_table = torch.zeros((V, D), dtype=dtype, device=tokens.device)
        if ctx.tp is None:
            g_table.index_add_(0, tokens.reshape(-1).long(), g_rows)
        else:
            local, inside = _vocab_rows(g_table, tokens, ctx.tp)
            g_table.index_add_(0, local.reshape(-1), g_rows * inside.reshape(-1, 1).to(dtype))
        return g_token, g_table, None, None, None, None


def check_schedule(B: int, cfg: ModelConfig, mesh, num_microbatches: Optional[int]) -> int:
    """The microbatch count M (default: the pp size), after JAX's two
    checks."""
    S = mesh.size("pp")
    M = num_microbatches or S
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers not divisible by pp={S}")
    return M


def dp_rows(n: int, mesh) -> tuple[slice, int, Optional[ShardRows]]:
    """This rank's dp shard of n rows as GSPMD lays them out: (the rows
    it holds, the rows every shard keeps (ceil(n / dp), padding
    included), its ``ShardRows``, None without dp)."""
    dp = mesh.comm("dp")
    if dp is None:
        return slice(0, n), n, None
    per = -(-n // dp.size)
    start = min(dp.index * per, n)
    stop = min(start + per, n)
    return slice(start, stop), per, ShardRows(dp, n, stop - start)


def real_rows(x: torch.Tensor, mesh, M: int, n: int) -> torch.Tensor:
    """The rows of x [M * per, ...] (``shard_rows``' layout of a batch of
    M microbatches of n rows each) that are this shard's own, padding
    left out."""
    rows, per, _ = dp_rows(n, mesh)
    return x.reshape(M, per, *x.shape[1:])[:, :rows.stop - rows.start].reshape(-1, *x.shape[1:])


def shard_rows(x: torch.Tensor, mesh, M: int) -> torch.Tensor:
    """This dp shard's rows of a batch x [B, ...] under the schedule: its
    block of each of the M microbatches (``dp_rows``), each padded with
    zero rows to ceil(B / M / dp), microbatch by microbatch; x itself
    without dp."""
    if mesh.comm("dp") is None:
        return x
    B, rest = x.shape[0], x.shape[1:]
    rows, per, _ = dp_rows(B // M, mesh)
    blocks = x.reshape(M, B // M, *rest)[:, rows]
    pad = blocks.new_zeros((M, per - blocks.shape[1], *rest))
    return torch.cat([blocks, pad], dim=1).reshape(M * per, *rest)


def gather_rows(x: torch.Tensor, mesh, M: int, B: int, dim: int = 0) -> torch.Tensor:
    """The shards' ``shard_rows`` outputs (the batch on ``dim``) gathered
    over dp back into the B rows of the batch, in order, padding left
    out; x itself without dp."""
    dp = mesh.comm("dp")
    if dp is None:
        return x
    whole = all_gather(x, dp, dim=dim)              # shard-major
    lead, rest, per = whole.shape[:dim], whole.shape[dim + 1:], x.shape[dim] // M
    blocks = whole.reshape(*lead, dp.size, M, per, *rest).transpose(dim, dim + 1)
    blocks = blocks.reshape(*lead, M, dp.size * per, *rest).narrow(dim + 1, 0, B // M)
    return blocks.reshape(*lead, B, *rest)


def dp_params(params, mesh):
    """The tree as each dp shard uses it: every leaf is replicated over
    "dp", so going back its gradient is summed over the shards
    (``copy_in``); the leaves themselves where autograd records nothing."""
    dp = mesh.comm("dp")
    if isinstance(params, dict):
        return {k: dp_params(v, mesh) for k, v in params.items()}
    return copy_in(params, dp)


def stage_forward(params, cfg: ModelConfig, tokens, q_positions, mesh, M: int, B: int,
                  keep_kv: bool = True):
    """This rank's part of the schedule over its dp shard's rows.

    tokens, q_positions: int [b, T], the shard's rows of the B-row batch
    (``shard_rows``: its block of each microbatch, in order, padded);
    params: this rank's slice by ``param_specs_pp``. Returns (the last
    stage's output [b, T, D] on every stage, this stage's k_chunk,
    v_chunk [L / pp, b, T, Hkv / tp, D], or None without ``keep_kv``)."""
    from omnia_tpu_torch.models.llama import _check_tp, _layer, _layers, _lookup
    from omnia_tpu_torch.ops.rope import rope_cos_sin

    _check_tp(params, cfg, mesh.comm("tp"))
    tp, pp = mesh.comm("tp"), mesh.comm("pp")
    dp = dp_rows(B // M, mesh)[2]                 # a microbatch's rows over dp
    S, s = mesh.size("pp"), mesh.index("pp")
    b, T = tokens.shape
    mb = b // M
    table = params["embed"]
    shape = (b, T, cfg.hidden_size)
    if pp is None:
        x = _lookup(table, tokens, tp)
    else:
        token = torch.zeros((), device=tokens.device, requires_grad=torch.is_grad_enabled())
        token, x = _Lookup.apply(token, table, tokens, shape, tp, pp)
    cos, sin = rope_cos_sin(q_positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    layers = _layers(params)
    state, outs, ks, vs = None, [], [], []
    for t in range(M + S - 1):
        m = t - s
        y = None
        if 0 <= m < M:
            rows = slice(m * mb, (m + 1) * mb)
            h = x[rows] if s == 0 else state
            kv = []
            for p in layers:
                h, k, v = _layer(h, p, cfg, cos[rows], sin[rows], q_positions[rows],
                                 None, None, None, tp, dp=dp)
                kv.append((k, v))
            if keep_kv:
                ks.append(torch.stack([k for k, _ in kv]))
                vs.append(torch.stack([v for _, v in kv]))
            if s == S - 1:
                outs.append(h)
            else:
                y = h
        like = None
        if s > 0 and 0 <= m + 1 < M:
            like = torch.empty((mb, T, cfg.hidden_size), dtype=table.dtype, device=table.device)
        if y is not None or like is not None:
            token, state = stage_send(token, y, like, pp)
    out = torch.cat(outs) if s == S - 1 else torch.empty(shape, dtype=table.dtype,
                                                         device=table.device)
    if pp is not None:
        _, out = broadcast(token, out, pp, S - 1)
    if not keep_kv:
        return out, None, None
    return out, torch.cat(ks, dim=1), torch.cat(vs, dim=1)


def pipeline_forward(params, cfg: ModelConfig, tokens, q_positions, mesh,
                     num_microbatches: Optional[int] = None):
    """Pipelined fresh prefill over the mesh's "pp" axis, with
    ``llama.forward_prefill``'s contract: tokens, q_positions int [B, T]
    (the whole batch, on every rank) → (logits [B, T, V] f32 on every
    rank, this stage's k_chunk, v_chunk [L / pp, B, T, Hkv / tp, D]).

    B must divide by ``num_microbatches`` (default: the pp size, the
    least M that keeps every stage busy between fill and drain); dp need
    not divide a microbatch. Params must be this rank's slice by
    ``llama.param_specs_pp``. Differentiable; the trainer's
    ``pipeline_loss_fn`` differentiates the same schedule."""
    from omnia_tpu_torch.models.llama import _logits, gather_logits

    B, T = tokens.shape
    M = check_schedule(B, cfg, mesh, num_microbatches)
    params = dp_params(params, mesh)
    out, k, v = stage_forward(params, cfg, shard_rows(tokens, mesh, M),
                              shard_rows(q_positions, mesh, M), mesh, M, B)
    logits = gather_logits(_logits(params, cfg, out, mesh.comm("tp")), mesh.comm("tp"))
    return (gather_rows(logits, mesh, M, B), gather_rows(k, mesh, M, B, dim=1),
            gather_rows(v, mesh, M, B, dim=1))

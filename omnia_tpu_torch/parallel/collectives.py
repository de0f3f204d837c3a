"""The collectives of the parallel paths, over one process group.

The JAX package writes no collective: GSPMD inserts them where a sharded
product needs one, and ring attention's and the pipeline's
``ppermute``. Here every rank is a process of its own, so the model, the
pipeline, the trainer and the engine call them explicitly, and only
these:

- ``all_reduce_sum``: after a row-parallel product (``wo``, ``wd``, the
  experts' combine, the vocab-parallel embedding lookup); over "dp" a
  training loss;
- ``all_reduce_max``: W8A8's per-row activation amax before a
  row-parallel product quantizes its slice of the row;
- ``copy_in``: nothing going forward; it marks an activation (or a
  param) that every rank of the axis holds whole and uses with its own
  slice of the weights (before q/k/v, ``wg``/``wu``, the experts, the
  vocabulary-sliced head), or a param replicated over "dp";
- ``all_gather``: the vocab-split logits a sampler or a loss reads, the KV
  heads of an exported session; over "dp" each shard's decode tokens;
  over "sp" a ring prefill's KV rows;
- ``broadcast``: over "dp" what one shard's slot produced (a first
  token, a session's or a prefix entry's rows); over "sp" the logits of
  the rank that holds a ring prefill's last row; over "pp" the last
  stage's output;
- ``Comm.shift``: ring attention's K/V block to the next rank of the
  "sp" ring (point-to-point send and receive, the ``ppermute`` analog);
- ``stage_send``: the pipeline's step from stage i to stage i + 1 (JAX's
  ``ppermute`` with pairs (i, i + 1) and no S - 1 -> 0 edge), this
  rank's send and receive posted together.

Each takes the :class:`Comm` of the axis, or None. **With None (tp = 1)
it returns its input and launches nothing**, so a tp = 1 forward runs
exactly the ops it ran before tensor parallelism existed.

**Gradients.** JAX differentiates through GSPMD's collectives by their
transposes; here the differentiable ones carry them by hand, as
``torch.autograd.Function``s: ``all_reduce_sum`` passes its gradient
through unchanged, ``copy_in`` sums its gradient over the axis
("all_reduce_backward"), ``all_gather`` hands back this rank's slice,
``broadcast`` gives its source the gradient and every other rank zero,
and ``stage_send`` sends the received tensor's gradient back to stage i
- 1 while the sent one's comes from stage i + 1 ("send_backward").
Where no gradient is recorded (grad mode off, or an input that needs
none) each runs exactly the ops it runs without autograd. Every rank of a
group must run a backward's collectives in one order: the pipeline
threads a scalar token through its sends, so that each rank's backward
reaches every send, last tick first.

Arithmetic is the same on every backend: a 16-bit float is reduced in
f32 and rounded back once, and gathered as its bytes. On
``nccl`` the f32 copy stays on the card; on ``gloo``, which the CPU
tests and ranks sharing one card use, a CUDA tensor is staged through
host memory (gloo's CUDA support covers only some collectives). Every
rank ends with the same bytes, which is what keeps the ranks' sampled
tokens equal.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

_HALF = (torch.bfloat16, torch.float16)


class Comm:
    """One mesh axis's process group: its size, this rank's index on it,
    and the collectives over it. ``stats`` counts the calls, the bytes
    this rank contributed (sent, for a point-to-point step) and, on gloo,
    the host seconds they took, the staging copies included (a NCCL call
    is asynchronous and is counted without seconds); ``op_stats`` splits
    them by operation ("all_reduce", "all_gather", "broadcast", "shift",
    "send", and a backward's "all_reduce_backward", "broadcast_backward",
    "send_backward"). The counts are taken in Python, where a call is
    made: a call captured into a CUDA graph (the decode ring's,
    ``engine/graphs.py``) counts once, at its capture, and the graph's
    replays are not in ``stats`` or ``op_stats``; ``RingGraphs`` records
    one captured step's collectives instead (``step_collectives``)."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = size
        self.index = index
        self.backend = dist.get_backend(group)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self.op_stats: dict = {}

    def _staged(self, x: torch.Tensor) -> bool:
        return x.is_cuda and self.backend != "nccl"

    def _tally(self, op: str, nbytes: int, t0: Optional[float]) -> None:
        seconds = time.perf_counter() - t0 if t0 is not None else 0.0
        per_op = self.op_stats.setdefault(op, {"calls": 0, "bytes": 0, "seconds": 0.0})
        for stats in (self.stats, per_op):
            stats["calls"] += 1
            stats["bytes"] += nbytes
            stats["seconds"] += seconds

    def _global(self, index: int) -> int:
        """The job rank of this group's rank ``index``."""
        return dist.get_global_rank(self.group, index) if self.group is not None else index

    def _start(self, x: torch.Tensor) -> Optional[float]:
        if self.backend == "nccl":
            return None
        if x.is_cuda:
            # Wait for the work that produces x outside the timed span.
            torch.cuda.current_stream(x.device).synchronize()
        return time.perf_counter()

    def all_reduce(self, x: torch.Tensor, op, name: str = "all_reduce") -> torch.Tensor:
        t0 = self._start(x)
        wide = torch.float32 if x.dtype in _HALF else x.dtype
        buf = x.to("cpu" if self._staged(x) else x.device, wide, copy=True)
        dist.all_reduce(buf, op=op, group=self.group)
        out = buf.to(x.device, x.dtype)
        self._tally(name, _nbytes(x), t0)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        t0 = self._start(x)
        src = x.contiguous()
        if src.dtype in _HALF:
            # Bytes (gloo takes no int16): the last dim doubles, and each
            # rank's block stays whole, so joining the bytes joins the values.
            src = src.view(torch.uint8)
        if self._staged(x):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        if x.dtype in _HALF:
            out = out.view(x.dtype)
        out = out.to(x.device)
        self._tally("all_gather", _nbytes(x), t0)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0, name: str = "broadcast") -> torch.Tensor:
        """x from group rank ``src`` on every rank (a new tensor; x is
        read on ``src`` only)."""
        t0 = self._start(x)
        buf = _as_bytes(x)
        buf = buf.cpu() if self._staged(x) else buf.clone()
        dist.broadcast(buf, src=self._global(src), group=self.group)
        out = _from_bytes(buf, x).to(x.device)
        self._tally(name, _nbytes(x), t0)
        return out

    def exchange(self, x: Optional[torch.Tensor], to: int, like: Optional[torch.Tensor],
                 frm: int, name: str) -> Optional[torch.Tensor]:
        """One point-to-point step: x (if any) goes to group rank ``to``
        and a tensor of ``like``'s shape, dtype and device (if any) comes
        from ``frm``, the send and the receive posted together, so no rank
        waits on another's order; on gloo a CUDA tensor is staged through
        host memory, on NCCL it moves card to card. Returns what came, or
        None."""
        t0 = self._start(x if x is not None else like)
        ops, recv = [], None
        if x is not None:
            buf = _as_bytes(x)
            buf = buf.cpu() if self._staged(x) else buf
            ops.append(dist.P2POp(dist.isend, buf, self._global(to), self.group))
        if like is not None:
            recv = _as_bytes(torch.empty(like.shape, dtype=like.dtype,
                                         device="cpu" if self._staged(like) else like.device))
            ops.append(dist.P2POp(dist.irecv, recv, self._global(frm), self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self._tally(name, 0 if x is None else _nbytes(x), t0)
        return None if like is None else _from_bytes(recv, like).to(like.device)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """The ring step: x goes to the next rank of the axis (index + 1
        mod size) and the previous rank's x comes back (a new tensor)."""
        return self.exchange(x, (self.index + 1) % self.size, x,
                             (self.index - 1) % self.size, "shift")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A 16-bit float as its bytes (gloo takes no int16 and not every
    16-bit float), contiguous; any other tensor contiguous."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _HALF and x.dim() > 0 else x


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.view(like.dtype) if like.dtype in _HALF and like.dim() > 0 else buf


@dataclasses.dataclass(frozen=True)
class ShardRows:
    """One dp shard's block of ``total`` batch rows, as GSPMD lays out a
    dimension that dp does not divide: shard r holds rows r·per to (r +
    1)·per (per = ceil(total / dp)), so the last shards hold fewer rows,
    or none. The shard's tensors keep ``per`` rows, the first ``valid``
    its own and the rest padding, so that every rank's collectives have
    one size. Passed as a forward's ``dp`` in place of the dp Comm (which
    means even shards, every row real)."""

    comm: Comm
    total: int
    valid: int


def batch_rows(dp, rows: int) -> tuple:
    """(the dp Comm or None, the whole batch's rows, this shard's real
    rows) of a forward over ``rows`` rows whose ``dp`` is None, the dp
    Comm or a ShardRows."""
    if dp is None:
        return None, rows, rows
    if isinstance(dp, ShardRows):
        return dp.comm, dp.total, dp.valid
    return dp, rows * dp.size, rows


def world_comm() -> Comm:
    """The default group's Comm (every rank of the job)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(omnia_tpu_torch.parallel.distributed.maybe_initialize_distributed)")
    return Comm(dist.group.WORLD, dist.get_world_size(), dist.get_rank())


def _recorded(x: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on x."""
    return x is not None and torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """SUM over the axis; its gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity; its gradient is summed over the axis."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g, dist.ReduceOp.SUM, "all_reduce_backward"), None


class _Gather(torch.autograd.Function):
    """The ranks' x joined along ``dim``; the gradient's slice of this
    rank goes back."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.comm.index * ctx.n, ctx.n), None, None


class _Broadcast(torch.autograd.Function):
    """x from rank ``src``; the source gets the gradient, every other rank
    zero (its x was never read). ``token`` orders the backward (module
    docstring)."""

    @staticmethod
    def forward(ctx, token, x, comm, src):
        ctx.source = comm.index == src
        return token.clone(), comm.broadcast(x, src)

    @staticmethod
    def backward(ctx, g_token, g):
        return g_token, (g if ctx.source else None), None, None


class _StageSend(torch.autograd.Function):
    """The pipeline step: y (if any) to the next stage, a tensor like
    ``like`` (if any) from the previous one. Backward: the received
    tensor's gradient goes back to the previous stage and y's comes from
    the next."""

    @staticmethod
    def forward(ctx, token, y, like, comm):
        ctx.comm = comm
        ctx.sent = None if y is None else (y.shape, y.dtype, y.device)
        ctx.received = like is not None
        got = comm.exchange(y, comm.index + 1, like, comm.index - 1, "send")
        return token.clone(), (token.new_empty(0) if got is None else got)

    @staticmethod
    def backward(ctx, g_token, g_got):
        comm = ctx.comm
        like = None
        if ctx.sent is not None:
            shape, dtype, device = ctx.sent
            like = torch.empty(shape, dtype=dtype, device=device)
        g_y = comm.exchange(g_got if ctx.received else None, comm.index - 1, like,
                            comm.index + 1, "send_backward")
        return g_token, g_y, None, None


def all_reduce_sum(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """Sum of x over the axis's ranks; x itself with no axis. Its
    gradient passes through unchanged."""
    if comm is None or comm.size == 1:
        return x
    if _recorded(x):
        return _Sum.apply(x, comm)
    return comm.all_reduce(x, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """Elementwise max of x over the axis's ranks; x itself with no axis."""
    if comm is None or comm.size == 1:
        return x
    return comm.all_reduce(x, dist.ReduceOp.MAX)


def copy_in(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """x, unchanged, where every rank of the axis holds it whole and each
    uses it with its own slice of the weights (or its own rows): its
    gradient is summed over the axis. x itself with no axis, or where
    autograd records nothing."""
    if comm is None or comm.size == 1 or not _recorded(x):
        return x
    return _Copy.apply(x, comm)


def all_gather(x: torch.Tensor, comm: Optional[Comm], dim: int = -1) -> torch.Tensor:
    """The ranks' x joined along ``dim`` in rank order; x itself with no
    axis. Its gradient is this rank's slice."""
    if comm is None or comm.size == 1:
        return x
    if _recorded(x):
        return _Gather.apply(x, comm, dim)
    return comm.all_gather(x, dim)


def broadcast(token: torch.Tensor, x: torch.Tensor, comm: Comm, src: int):
    """(token, x from group rank ``src`` on every rank): the pipeline's
    output, whose gradient only its source takes back."""
    return _Broadcast.apply(token, x, comm, src)


def stage_send(token: torch.Tensor, y: Optional[torch.Tensor], like: Optional[torch.Tensor],
               comm: Comm):
    """One tick of the pipeline on this stage: y (None: nothing to send)
    to stage index + 1 and a tensor like ``like`` (None: nothing to
    receive) from stage index - 1, posted together. Returns (token, what
    came or an empty tensor)."""
    return _StageSend.apply(token, y, like, comm)

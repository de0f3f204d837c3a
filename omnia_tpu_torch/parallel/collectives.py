"""The collectives of the tensor-parallel path, over one process group.

The JAX package writes no collective: GSPMD inserts them where a sharded
product needs one. Here every rank is a process of its own, so the model
calls them explicitly, and only these:

- ``all_reduce_sum``: after a row-parallel product (``wo``, ``wd``, the
  experts' combine, the vocab-parallel embedding lookup);
- ``all_reduce_max``: W8A8's per-row activation amax before a
  row-parallel product quantizes its slice of the row;
- ``all_gather``: the vocab-split logits a sampler reads, and the KV
  heads of an exported session.

Each takes the :class:`Comm` of the axis, or None. **With None (tp = 1)
it returns its input and launches nothing**, so a tp = 1 forward runs
exactly the ops it ran before tensor parallelism existed.

Arithmetic is the same on every backend: a 16-bit float is reduced in
f32 and rounded back once, and gathered as its bytes. On
``nccl`` the f32 copy stays on the card; on ``gloo``, which the CPU
tests and ranks sharing one card use, a CUDA tensor is staged through
host memory (gloo's CUDA support covers only some collectives). Every
rank ends with the same bytes, which is what keeps the ranks' sampled
tokens equal.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

_HALF = (torch.bfloat16, torch.float16)


class Comm:
    """One mesh axis's process group: its size, this rank's index on it,
    and the collectives over it. ``stats`` counts the calls, the bytes
    this rank contributed and, on gloo, the host seconds they took, the
    staging copies included (a NCCL call is asynchronous and is counted
    without seconds)."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = size
        self.index = index
        self.backend = dist.get_backend(group)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def _staged(self, x: torch.Tensor) -> bool:
        return x.is_cuda and self.backend != "nccl"

    def _tally(self, x: torch.Tensor, t0: Optional[float]) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()
        if t0 is not None:
            self.stats["seconds"] += time.perf_counter() - t0

    def _start(self, x: torch.Tensor) -> Optional[float]:
        if self.backend == "nccl":
            return None
        if x.is_cuda:
            # Wait for the work that produces x outside the timed span.
            torch.cuda.current_stream(x.device).synchronize()
        return time.perf_counter()

    def all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        t0 = self._start(x)
        wide = torch.float32 if x.dtype in _HALF else x.dtype
        buf = x.to("cpu" if self._staged(x) else x.device, wide, copy=True)
        dist.all_reduce(buf, op=op, group=self.group)
        out = buf.to(x.device, x.dtype)
        self._tally(x, t0)
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
        self._tally(x, t0)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """x from group rank ``src`` on every rank (a new tensor; x is
        read on ``src`` only)."""
        t0 = self._start(x)
        buf = x.cpu() if self._staged(x) else x.clone()
        dist.broadcast(buf, src=dist.get_global_rank(self.group, src)
                       if self.group is not None else src, group=self.group)
        out = buf.to(x.device)
        self._tally(x, t0)
        return out


def world_comm() -> Comm:
    """The default group's Comm (every rank of the job)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(omnia_tpu_torch.parallel.distributed.maybe_initialize_distributed)")
    return Comm(dist.group.WORLD, dist.get_world_size(), dist.get_rank())


def all_reduce_sum(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """Sum of x over the axis's ranks; x itself with no axis."""
    if comm is None or comm.size == 1:
        return x
    return comm.all_reduce(x, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """Elementwise max of x over the axis's ranks; x itself with no axis."""
    if comm is None or comm.size == 1:
        return x
    return comm.all_reduce(x, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, comm: Optional[Comm], dim: int = -1) -> torch.Tensor:
    """The ranks' x joined along ``dim`` in rank order; x itself with no
    axis."""
    if comm is None or comm.size == 1:
        return x
    return comm.all_gather(x, dim)

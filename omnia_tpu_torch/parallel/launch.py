"""Start a job of ranks on this host: one spawned process per rank, each
joined to the process group through the env contract of
``parallel/distributed.py`` before it runs the caller's function.

    results = spawn_ranks(fn, world=2, args=(cfg_name,), backend="gloo")

``fn(rank, *args)`` must be importable by its module path (a spawned
process starts from a fresh import) and its result picklable; the list
of results comes back in rank order. A rank that raises fails the job
with its traceback; a job that outlives ``timeout_s`` is killed.
"""

from __future__ import annotations

import gc
import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional

import torch.multiprocessing as mp

from omnia_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: Optional[str],
               rank_timeout_s: float, env: dict, fn: Callable, args: tuple, out) -> None:
    os.environ.update(env)
    os.environ.update(OMNIA_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      OMNIA_NUM_PROCESSES=str(world), OMNIA_PROCESS_ID=str(rank))
    import torch.distributed as dist

    from omnia_tpu_torch.parallel.distributed import maybe_initialize_distributed

    try:
        maybe_initialize_distributed(backend=backend, timeout_s=rank_timeout_s)
        result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            # NCCL's communicator destroy waits until every CUDA graph that
            # captured one of its collectives (a decode ring's) is destroyed:
            # free the engines fn left in reference cycles first.
            gc.collect()
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (), backend: Optional[str] = None,
                env: Optional[dict] = None, timeout_s: float = 600.0,
                rank_timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks of one process
    group; their results in rank order. ``rank_timeout_s`` is the group's
    bound on a collective's wait for its peers."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, rank_timeout_s, dict(env or {}), fn, args, out),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    failures = []
    deadline = time.monotonic() + timeout_s
    try:
        # Drain the queue before joining: a child blocks on a full pipe.
        while len(results) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # A rank died without reporting (killed): the others
                    # wait in a collective; give them a moment, then stop.
                    deadline = min(deadline, time.monotonic() + 30)
                continue
            if ok:
                results[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                deadline = min(deadline, time.monotonic() + 10)
        if failures:
            raise RuntimeError("ranks failed:\n" + "\n".join(failures))
        if len(results) < world:
            raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} did not "
                               f"finish within {timeout_s}s")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]

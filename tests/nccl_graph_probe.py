"""Can an NCCL collective be captured inside a conditional (IF) body of a
CUDA graph, as the decode ring's step body captures its tp and dp
collectives (``omnia_tpu_torch/engine/graphs.py``)? One rank per card:

    python3 tests/nccl_graph_probe.py [world, default 2]

For each route, with NCCL's graph mixing at its default and then off
(``NCCL_GRAPH_MIXING_SUPPORT=0``), every rank captures one graph whose
predicate is a MAX all-reduce of a one-element int32 flag on the capture
stream, and whose IF body sums a [4096] f32 vector over the ranks:

- ``plain``: the sum captured with no IF node (the control);
- ``pg``: the sum inside the IF body through PyTorch's ProcessGroupNCCL
  (``Comm.all_reduce``), as the engine makes it;
- ``nccl``: the sum inside the IF body as a direct ``ncclAllReduce`` on
  the body stream, over the process group's communicator.

It then replays the graph three times (flag set on rank 0, set, clear:
the body runs, runs, is skipped) and 100 times more for the mean replay
time. Prints one JSON line per route and setting: every rank's result,
``ok`` false with the traceback where the capture or a replay failed.
Imports torch and the port only."""

from __future__ import annotations

import ctypes
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROUTES = (("plain", {}), ("pg", {}), ("nccl", {}),
          ("pg", {"NCCL_GRAPH_MIXING_SUPPORT": "0"}),
          ("nccl", {"NCCL_GRAPH_MIXING_SUPPORT": "0"}))
_NCCL_FLOAT32, _NCCL_SUM = 7, 0


def _nccl_lib():
    """The libnccl this process loaded (PyTorch's), and its path."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libnccl" in line:
                path = line.split()[-1]
                return ctypes.CDLL(path), path
    return ctypes.CDLL("libnccl.so.2"), "libnccl.so.2"


def probe(rank: int, route: str) -> dict:
    from omnia_tpu_torch.engine import graphs
    from omnia_tpu_torch.parallel.collectives import world_comm

    out = {"route": route, "env_mixing": os.environ.get("NCCL_GRAPH_MIXING_SUPPORT")}
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        comm = world_comm()
        lib = graphs._lib()
        cap, body = graphs._streams(dev)
        x = torch.full((4096,), float(rank + 1), device=dev)
        res = torch.zeros_like(x)
        flag = torch.ones(1, dtype=torch.int32, device=dev)
        # NCCL makes its communicator at the first call, outside the capture.
        comm.all_reduce(x, dist.ReduceOp.SUM)
        comm.all_reduce(flag, dist.ReduceOp.MAX)
        torch.cuda.synchronize()
        backend = dist.group.WORLD._get_backend(dev)
        nlib, path = _nccl_lib()
        comm_ptr = backend._comm_ptr() if hasattr(backend, "_comm_ptr") else None
        out.update(nccl_path=path, nccl_version=str(torch.cuda.nccl.version()),
                   comm_ptr=bool(comm_ptr))
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        body_pool = torch.cuda.MemPool()

        def body_work():
            if route in ("pg", "plain"):
                res.copy_(comm.all_reduce(x, dist.ReduceOp.SUM))
                return
            nlib.ncclAllReduce.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
            err = nlib.ncclAllReduce(x.data_ptr(), res.data_ptr(), x.numel(), _NCCL_FLOAT32,
                                     _NCCL_SUM, comm_ptr, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"ncclAllReduce returned {err}")

        t0 = time.monotonic()
        with torch.cuda.graph(graph, pool=pool, stream=cap, capture_error_mode="thread_local"):
            pred = comm.all_reduce(flag, dist.ReduceOp.MAX)
            if route == "plain":
                body_work()
            else:
                err = lib.omnia_graph_if_begin(cap.cuda_stream, pred.data_ptr(), 4,
                                               body.cuda_stream)
                if err:
                    raise RuntimeError(f"omnia_graph_if_begin returned {err}")
                try:
                    with torch.cuda.stream(body), torch.cuda.use_mem_pool(body_pool, dev):
                        body_work()
                finally:
                    out["if_end"] = lib.omnia_graph_if_end(body.cuda_stream)
        torch.cuda.synchronize()
        out["capture_s"] = time.monotonic() - t0
        vals = []
        for v, f in ((1.0, 1), (3.0, 1), (5.0, 0)):
            x.fill_(v * (rank + 1))
            flag.fill_(f if rank == 0 else 0)
            if f:
                res.zero_()
            graph.replay()
            torch.cuda.synchronize()
            vals.append(float(res[0]))
        out["vals"] = vals
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(100):
            graph.replay()
        torch.cuda.synchronize()
        out["replay_us"] = (time.monotonic() - t0) * 1e4
        out["ok"] = True
    except Exception:
        out["error"] = traceback.format_exc()[-3000:]
        out["ok"] = False
    return out


def main() -> None:
    from omnia_tpu_torch import kernels
    from omnia_tpu_torch.parallel.launch import spawn_ranks

    print(torch.__version__, torch.version.cuda, torch.cuda.device_count(), flush=True)
    kernels.build("graph_cond")
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    for route, env in ROUTES:
        t0 = time.monotonic()
        try:
            got = spawn_ranks(probe, world, args=(route,), backend="nccl", env=env,
                              timeout_s=90, rank_timeout_s=45)
        except Exception as e:
            got = [f"spawn failed: {str(e)[-3000:]}"]
        print(json.dumps(dict(route=route, env=env, s=time.monotonic() - t0, got=got)),
              flush=True)


if __name__ == "__main__":
    main()

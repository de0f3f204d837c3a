"""Joining the job's process group (port of
``omnia_tpu/parallel/distributed.py``).

Env contract, the JAX package's (stamped into multi-host pods by the
deployment, as GKE JobSets and indexed Jobs expose a rank):

  OMNIA_COORDINATOR_ADDR  host:port of process 0
  OMNIA_NUM_PROCESSES     world size
  OMNIA_PROCESS_ID        this pod's rank (default: the trailing integer
                          of the pod's hostname, the StatefulSet /
                          indexed-Job convention)

Each rank is one process: ``maybe_initialize_distributed`` calls
``torch.distributed.init_process_group`` over ``tcp://`` at that address.
The backend is the caller's choice, by default ``nccl`` where the rank
has a card and ``gloo`` where it has none; a failed init raises, and no
other backend is tried. The decode ring under tp or dp on the card needs
``NCCL_GRAPH_MIXING_SUPPORT=0`` in the job's environment, set by the job
and checked by ``engine.validate_parallel``: its CUDA graphs capture NCCL
collectives inside conditional (IF) bodies, which refuse the event nodes
NCCL adds with graph mixing on (``parallel/mesh.py::capture_comms`` keeps those collectives on
communicators that run nothing else).
"""

from __future__ import annotations

import datetime
import logging
import os
import re
import threading
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_initialized: Optional[dict] = None

#: How long a collective waits for its peers before it raises.
DEFAULT_TIMEOUT_S = 600.0
#: NCCL's switch for graph mixing, read at its first communicator
#: (module docstring).
GRAPH_MIXING = "NCCL_GRAPH_MIXING_SUPPORT"


def _infer_process_id(env) -> Optional[int]:
    explicit = env.get("OMNIA_PROCESS_ID")
    if explicit is not None:
        return int(explicit)
    # StatefulSet / indexed-Job pods end in their ordinal: agent-7b-3.
    m = re.search(r"-(\d+)$", env.get("HOSTNAME", ""))
    return int(m.group(1)) if m else None


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize_distributed(env=None, backend: Optional[str] = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[dict]:
    """Join the job's process group iff OMNIA_COORDINATOR_ADDR is set.
    Idempotent. Returns {"num_processes", "process_id", "backend"} when
    distributed, None for the single-process path (no env, no effect).
    ``timeout_s`` bounds every collective's wait for its peers: a rank
    that never arrives makes the others raise after it."""
    global _initialized
    env = env if env is not None else os.environ
    addr = env.get("OMNIA_COORDINATOR_ADDR")
    if not addr:
        return None
    with _lock:
        if _initialized is not None:
            return _initialized
        num = int(env.get("OMNIA_NUM_PROCESSES", "1"))
        pid = _infer_process_id(env)
        if pid is None:
            raise RuntimeError(
                "OMNIA_COORDINATOR_ADDR set but no OMNIA_PROCESS_ID and the "
                "hostname carries no trailing ordinal"
            )
        backend = backend or default_backend()
        dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                                world_size=num, rank=pid,
                                timeout=datetime.timedelta(seconds=timeout_s))
        if backend == "nccl":
            # NCCL takes one rank per card: the rank's collectives and
            # its default "cuda" tensors go to its own card.
            torch.cuda.set_device(rank_device())
        _initialized = {"num_processes": num, "process_id": pid, "backend": backend}
        logger.info("joined process group: rank %d/%d via %s (%s)", pid, num, addr, backend)
        return _initialized


def rank_device() -> torch.device:
    """A rank's default device: ``cuda:{local_rank % device_count}``, the
    local rank from LOCAL_RANK, else the global rank."""
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())

"""Tensor parallelism over ``torch.distributed`` (port of ``omnia_tpu/parallel``:
the mesh, sharding by spec, the env contract; plus the explicit
collectives that GSPMD inserts in the JAX package)."""

from omnia_tpu_torch.parallel.collectives import Comm, all_gather, all_reduce_max, all_reduce_sum
from omnia_tpu_torch.parallel.distributed import maybe_initialize_distributed
from omnia_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from omnia_tpu_torch.parallel.sharding import P, gather_pytree, shard_pytree

__all__ = [
    "Comm", "Mesh", "P", "all_gather", "all_reduce_max", "all_reduce_sum",
    "gather_pytree", "make_mesh", "maybe_initialize_distributed", "shard_pytree",
    "single_device_mesh",
]

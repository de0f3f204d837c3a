"""The mesh over the job's ranks (port of ``omnia_tpu/parallel/mesh.py``).

Axis conventions, as in the JAX package:

- "dp": data parallel (request slots in serving, the batch in training);
- "pp": pipeline stages; "sp": sequence parallel (ring attention);
- "tp": tensor parallel: attention heads, FFN hidden, experts, vocab.

A JAX mesh is an array of devices that one controller drives. Here each
rank is a process of its own, so the mesh is this rank's view of the
job: the axes' sizes, this rank's coordinate on each, and one process
group (a :class:`~omnia_tpu_torch.parallel.collectives.Comm`) per axis
of more than one rank. Ranks are laid out in the JAX package's axis
order, ("dp", "pp", "sp", "tp"), tp the fastest-varying.

Only tensor parallelism is ported: a degree above 1 on "dp", "sp" or
"pp" raises, naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from omnia_tpu_torch.parallel.collectives import Comm

# Axes whose degree may not exceed 1 yet: (axis, ROADMAP item).
_UNPORTED_AXES = (("dp", "A13 (dp)"), ("sp", "A13 (sp)"), ("pp", "A13 (pp)"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. ``shape`` maps every kept axis to
    its size (dp and tp always, pp and sp when above 1, as the JAX
    package keeps them); ``coords`` this rank's index on each;
    ``comms`` the axes of more than one rank."""

    shape: dict
    coords: dict
    comms: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def comm(self, axis: str) -> Optional[Comm]:
        """The axis's Comm, None where it has one rank (the collectives'
        no-op)."""
        return self.comms.get(axis)


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """This rank's mesh of dp x pp x sp x tp ranks: the first
    ``dp*pp*sp*tp`` ranks of the job, in ("dp", "pp", "sp", "tp") order.

    ``world`` and ``rank`` default to the initialized process group's
    (1 and 0 without one). A tp axis of more than one rank needs the
    process group, and (dp, sp and pp being 1) spans the whole job."""
    if dist.is_initialized():
        world = dist.get_world_size() if world is None else world
        rank = dist.get_rank() if rank is None else rank
    world = 1 if world is None else world
    rank = 0 if rank is None else rank
    n = dp * tp * sp * pp
    if world < n:
        raise ValueError(f"mesh {dp}x{pp}x{sp}x{tp} needs {n} devices, have {world}")
    for axis, item in _UNPORTED_AXES:
        degree = {"dp": dp, "sp": sp, "pp": pp}[axis]
        if degree > 1:
            raise ValueError(f"mesh axis {axis}={degree} is not ported to "
                             f"omnia_tpu_torch yet (ROADMAP {item})")
    dims = [("dp", dp), ("pp", pp), ("sp", sp), ("tp", tp)]
    shape = {name: size for name, size in dims if size > 1 or name in ("dp", "tp")}
    comms = {}
    if tp > 1:
        if not dist.is_initialized():
            raise RuntimeError(
                f"a tp={tp} mesh needs a torch.distributed process group "
                "(omnia_tpu_torch.parallel.distributed.maybe_initialize_distributed)")
        if world != tp:
            # With dp, sp and pp at 1 the tp group is the whole job.
            raise ValueError(f"a tp={tp} mesh needs a job of {tp} ranks, have {world}")
        comms["tp"] = Comm(dist.group.WORLD, tp, rank)
    coords = dict.fromkeys(shape, 0)
    coords["tp"] = rank % tp
    return Mesh(shape=shape, coords=coords, comms=comms)


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, world=1, rank=0)

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
order, ("dp", "pp", "sp", "tp"), tp the fastest-varying: rank
``((d * pp + p) * sp + s) * tp + t`` sits at dp = d, pp = p, sp = s,
tp = t.

An axis's group holds the ranks that differ only on that axis: each (dp,
pp, sp) position has its own tp group, each (dp, sp, tp) position its
own pipeline of pp stages, each (dp, pp, tp) one its own sp ring, each
(pp, sp, tp) one its own dp group. ``dist.new_group`` is collective over
the whole job, so every rank creates every group of every axis, in one
fixed order, including the groups it is not in; a job keeps the groups
of each mesh shape it made, so that the engine and its checkpoint
loader share them. An axis that spans the whole job uses the default
group.

``capture_comms`` gives an engine a second set of groups, over the same
lines, for the collectives that the decode ring captures into its CUDA
graphs: NCCL's captured kernels are legal inside a graph's conditional
(IF) bodies only with its graph-mixing support off
(``NCCL_GRAPH_MIXING_SUPPORT=0``), and a communicator without it must
never have a graph launch outstanding when an uncaptured call is made on
it. The eager collectives (prefills, the dp token gather, the lockstep
tick) stay on the mesh's own groups; the captured ones only ever run as
graph replays, enqueued one after another on the engine's stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from omnia_tpu_torch.parallel.collectives import Comm

# The groups made for each mesh shape of this job: {(dims, world group):
# {axis: group}}. new_group is collective, so a shape's groups are made
# once, by every rank, in the same order.
_GROUPS: dict = {}


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


def _axis_groups(dims: dict, world: int, role: str = "") -> dict:
    """{axis: the process group of this rank's line along it} for every
    axis of more than one rank, made (once per shape and ``role``) by
    every rank. The default role's whole-job axis uses the default group;
    another role (``capture_comms``) gets groups of its own for every
    axis."""
    key = (tuple(dims.items()), id(dist.group.WORLD), role)
    if key in _GROUPS:
        return _GROUPS[key]
    rank = dist.get_rank()
    strides, step = {}, 1
    for axis in reversed(dims):
        strides[axis] = step
        step *= dims[axis]
    groups = {}
    for axis, size in dims.items():
        if size == 1:
            continue
        if size == world and not role:
            groups[axis] = dist.group.WORLD
            continue
        others = [a for a in dims if a != axis]
        # Every line along `axis`: fix the other coordinates, vary this one.
        bases = [0]
        for a in others:
            bases = [b + i * strides[a] for b in bases for i in range(dims[a])]
        for base in sorted(bases):
            ranks = [base + i * strides[axis] for i in range(size)]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    _GROUPS[key] = groups
    return groups


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """This rank's mesh of dp x pp x sp x tp ranks, in ("dp", "pp", "sp",
    "tp") order.

    ``world`` and ``rank`` default to the initialized process group's
    (1 and 0 without one). A mesh of more than one rank needs the process
    group, and spans the whole job: one rank per mesh position."""
    if dist.is_initialized():
        world = dist.get_world_size() if world is None else world
        rank = dist.get_rank() if rank is None else rank
    world = 1 if world is None else world
    rank = 0 if rank is None else rank
    n = dp * tp * sp * pp
    if world < n:
        raise ValueError(f"mesh {dp}x{pp}x{sp}x{tp} needs {n} devices, have {world}")
    dims = {"dp": dp, "pp": pp, "sp": sp, "tp": tp}
    shape = {name: size for name, size in dims.items() if size > 1 or name in ("dp", "tp")}
    label = ", ".join(f"{a}={s}" for a, s in dims.items() if s > 1)
    comms = {}
    if n > 1:
        if world != n:
            # One rank per mesh position: the mesh is the whole job.
            raise ValueError(f"a {label} mesh needs a job of {n} ranks, have {world}")
        if not dist.is_initialized():
            raise RuntimeError(
                f"a {label} mesh needs a torch.distributed process group "
                "(omnia_tpu_torch.parallel.distributed.maybe_initialize_distributed)")
        for axis, group in _axis_groups(dims, world).items():
            comms[axis] = Comm(group, dims[axis], _coords(rank, dims)[axis])
    coords = {axis: c for axis, c in _coords(rank, dims).items() if axis in shape}
    return Mesh(shape=shape, coords=coords, comms=comms)


def capture_comms(mesh: Mesh, axes: tuple = ("dp", "tp")) -> dict:
    """{axis: Comm} over groups of their own along ``mesh``'s lines, for
    the collectives a CUDA graph captures (module docstring), for each of
    ``axes`` that has more than one rank. Collective over the whole job
    the first time a shape asks (``new_group``): every rank calls it at
    the same point."""
    dims = {a: mesh.size(a) for a in ("dp", "pp", "sp", "tp")}
    groups = _axis_groups(dims, dist.get_world_size(), role="capture")
    return {axis: Comm(groups[axis], dims[axis], mesh.index(axis))
            for axis in axes if axis in groups}


def _coords(rank: int, dims: dict) -> dict:
    """A rank's index on each axis of ``dims`` (the last the fastest)."""
    coords = {}
    for axis in reversed(dims):
        coords[axis] = rank % dims[axis]
        rank //= dims[axis]
    return {axis: coords[axis] for axis in dims}


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, world=1, rank=0)

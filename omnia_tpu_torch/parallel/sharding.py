"""Sharding by spec (port of ``omnia_tpu/parallel/sharding.py``).

A spec is the port's stand-in for ``jax.sharding.PartitionSpec``: a
tuple with one entry per dimension, the mesh axis the dimension is split
over or None. ``shard_pytree`` takes this rank's slice of every leaf by
its spec (JAX's ``device_put`` with a ``NamedSharding``, seen from one
rank); ``gather_pytree`` is its inverse, an all-gather over each split
axis, for export and tests.

Trees are nested dicts, tuples, ``QuantKV`` and ``PagedKV`` (the spec
tree has the same structure); a quantized weight is a dict like any
other.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from omnia_tpu_torch.parallel.collectives import all_gather


class P(tuple):
    """PartitionSpec: ``P(None, "tp")`` splits dim 1 over "tp"."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def tree_map_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(specs, P):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(tree_map_specs(fn, s, *(t[i] for t in trees)) for i, s in enumerate(specs))
    fields = getattr(type(specs), "__slots__", None)
    if fields:
        # QuantKV (q, s) and PagedKV (pool, table): built from their slots.
        return type(specs)(*(tree_map_specs(fn, getattr(specs, f),
                                            *(getattr(t, f) for t in trees)) for f in fields))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def _dense_copy(t: torch.Tensor) -> torch.Tensor:
    """A dense copy of ``t`` keeping its dimension order in memory (a
    column-major W8A8 weight stays column-major)."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    inverse = sorted(range(t.dim()), key=order.__getitem__)
    return t.permute(order).contiguous().permute(inverse)


def shard_leaf(x: torch.Tensor, spec, mesh, device=None) -> torch.Tensor:
    """This rank's slice of ``x`` by ``spec``, as a dense tensor of its own
    on ``device`` (default x's). A split dimension must divide evenly."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the leaf's {x.dim()} dims")
    for d, axis in enumerate(spec):
        n = mesh.size(axis) if axis is not None else 1
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split over "
                             f"{axis}={n}")
        step = x.shape[d] // n
        x = x.narrow(d, mesh.index(axis) * step, step)
    if device is not None:
        x = x.to(device)
    return _dense_copy(x)


def shard_pytree(tree, specs, mesh, device=None):
    """Every leaf of ``tree`` replaced by this rank's slice (``shard_leaf``)."""
    return tree_map_specs(lambda s, x: shard_leaf(x, s, mesh, device), specs, tree)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice: an all-gather over each
    split axis (a collective: every rank of the axis calls it)."""
    for d, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            x = all_gather(x, mesh.comm(axis), dim=d)
    return x


def gather_pytree(tree, specs, mesh: Optional[object]):
    """The inverse of ``shard_pytree``: every leaf whole on every rank."""
    return tree_map_specs(lambda s, x: gather_leaf(x, s, mesh), specs, tree)

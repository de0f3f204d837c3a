"""Random weights from the run's seed, in the port's tree layout.

The configuration's family (``portbench/families``) gives the leaves:
each path with its depth (the blocks stacked on its leading axis, None
for a leaf outside the layers), the shape of one block and its std.
Each (leaf, index) block is drawn on the device in the served dtype by
a ``torch.Generator`` of its own, seeded from the run's seed, the leaf
and the index. So the same seed gives the same weights on every card,
a rank can draw a leaf's block whole and keep its slice, and the
reference can draw one block again after the program has been freed,
without ever holding the whole model. Norm weights (std None) are
1 + 0.1·N(0, 1), so that a norm whose weight is ignored shows.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench import families


def _seed(seed: int, leaf: str, index: int) -> int:
    h = seed % (1 << 62)
    for ch in f"{leaf}/{index}".encode():
        h = (h * 1_000_003 + ch) % (1 << 62)
    return h


def leaves(cfg: dict) -> dict:
    """Leaf path → (depth, shape of one block, std), from the family."""
    return families.of(cfg).leaves(cfg)


def _fill(t: torch.Tensor, seed: int, leaf: str, index: int, std) -> torch.Tensor:
    gen = torch.Generator(device=t.device).manual_seed(_seed(seed, leaf, index))
    t.normal_(generator=gen)
    return t.mul_(0.1).add_(1.0) if std is None else t.mul_(std)


def draw_leaf(cfg: dict, seed: int, leaf: str, index: int, device,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Block ``index`` of a stacked leaf (index ignored for a global leaf)."""
    _, shape, std = leaves(cfg)[leaf]
    return _fill(torch.empty(shape, device=device, dtype=dtype), seed, leaf, index, std)


def _put(tree: dict, path: str, value) -> None:
    *keys, last = path.split(".")
    for k in keys:
        tree = tree.setdefault(k, {})
    tree[last] = value


@torch.no_grad()
def draw(cfg: dict, seed: int, device, dtype: torch.dtype = torch.bfloat16,
         cut: Optional[Callable] = None) -> dict:
    """The served tree for ``seed``. ``cut(path, block)`` gives the slice
    of a global leaf or of one block of a stacked leaf that this rank
    keeps (the whole of it by default)."""
    tree: dict = {}
    for path, (depth, shape, std) in leaves(cfg).items():
        if depth is None:
            t = draw_leaf(cfg, seed, path, 0, device, dtype)
            _put(tree, path, t if cut is None else cut(path, t))
        elif cut is None:
            # Each block drawn straight into its row of the stack.
            stacked = torch.empty((depth, *shape), device=device, dtype=dtype)
            for i in range(depth):
                _fill(stacked[i], seed, path, i, std)
            _put(tree, path, stacked)
        else:
            _put(tree, path, torch.stack(
                [cut(path, draw_leaf(cfg, seed, path, i, device, dtype)).clone()
                 for i in range(depth)]))
    return tree


@torch.no_grad()
def block(cfg: dict, seed: int, prefix: str, i: int, device,
          dtype: torch.dtype = torch.bfloat16) -> dict:
    """Block i of every leaf under ``prefix``, drawn again from the seed
    (for the reference), as a tree without the prefix."""
    tree: dict = {}
    for path in leaves(cfg):
        if path.startswith(prefix + "."):
            _put(tree, path[len(prefix) + 1:], draw_leaf(cfg, seed, path, i, device, dtype))
    return tree


def layer(cfg: dict, seed: int, i: int, device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Layer i's weights, drawn again from the seed (for the reference)."""
    return block(cfg, seed, "layers", i, device, dtype)


@torch.no_grad()
def globals_(cfg: dict, seed: int, device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The leaves outside the layers, drawn again from the seed."""
    return {p: draw_leaf(cfg, seed, p, 0, device, dtype)
            for p, (depth, _, _) in leaves(cfg).items() if depth is None}

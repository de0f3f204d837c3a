"""Random weights from the run's seed, in the port's tree layout.

The tree is the one ``omnia_tpu_torch.models.llama`` serves: a dict with
every layer stacked on a leading [L] axis and projections stored ``[in,
out]``. Each (leaf, layer) is drawn on the device in the served dtype by
a ``torch.Generator`` of its own, seeded from the run's seed, the leaf
and the layer. So the same seed gives the same weights on every card,
a rank can draw a leaf's layer whole and keep its slice, and the
reference can draw one layer again after the program has been freed,
without ever holding the whole model. Norm weights are 1 + 0.1·N(0, 1),
so that a norm whose weight is ignored shows; the rest keep the usual
initializer's scales (the configuration's ``initializer_range``, 0.02
where it gives none, and that / sqrt(2L) for the output projections).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

GLOBAL = ("embed", "final_norm", "lm_head")


def _seed(seed: int, leaf: str, layer: int) -> int:
    h = seed % (1 << 62)
    for ch in f"{leaf}/{layer}".encode():
        h = (h * 1_000_003 + ch) % (1 << 62)
    return h


def leaves(cfg: dict) -> dict:
    """Leaf path → (shape of one layer's block or of a global leaf, std);
    std None for a norm weight."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = cfg.get("head_dim") or D // H
    F, V, E = cfg["intermediate_size"], cfg["vocab_size"], cfg.get("num_local_experts", 0)
    std = cfg.get("initializer_range", 0.02)
    out_std = std / (2 * L) ** 0.5
    experts = (E,) if E else ()
    out = {
        "embed": ((V, D), std),
        "layers.ln1": ((D,), None),
        "layers.ln2": ((D,), None),
        "layers.attn.wq": ((D, H * Dh), std),
        "layers.attn.wk": ((D, Hkv * Dh), std),
        "layers.attn.wv": ((D, Hkv * Dh), std),
        "layers.attn.wo": ((H * Dh, D), out_std),
    }
    if E:
        out["layers.mlp.router"] = ((D, E), std)
    out["layers.mlp.wg"] = ((*experts, D, F), std)
    out["layers.mlp.wu"] = ((*experts, D, F), std)
    out["layers.mlp.wd"] = ((*experts, F, D), out_std)
    out["final_norm"] = ((D,), None)
    if not cfg.get("tie_word_embeddings"):
        out["lm_head"] = ((D, V), std)
    return out


def _fill(t: torch.Tensor, seed: int, leaf: str, layer: int, std) -> torch.Tensor:
    gen = torch.Generator(device=t.device).manual_seed(_seed(seed, leaf, layer))
    t.normal_(generator=gen)
    return t.mul_(0.1).add_(1.0) if std is None else t.mul_(std)


def draw_leaf(cfg: dict, seed: int, leaf: str, layer: int, device,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One layer's block of a stacked leaf (layer ignored for a global leaf)."""
    shape, std = leaves(cfg)[leaf]
    return _fill(torch.empty(shape, device=device, dtype=dtype), seed, leaf, layer, std)


def _put(tree: dict, path: str, value) -> None:
    *keys, last = path.split(".")
    for k in keys:
        tree = tree.setdefault(k, {})
    tree[last] = value


@torch.no_grad()
def draw(cfg: dict, seed: int, device, dtype: torch.dtype = torch.bfloat16,
         cut: Optional[Callable] = None) -> dict:
    """The served tree for ``seed``. ``cut(path, block)`` gives the slice
    of a global leaf or of one layer's block that this rank keeps (the
    whole of it by default)."""
    L = cfg["num_hidden_layers"]
    tree: dict = {}
    for path, (shape, std) in leaves(cfg).items():
        if path in GLOBAL:
            t = draw_leaf(cfg, seed, path, 0, device, dtype)
            _put(tree, path, t if cut is None else cut(path, t))
            continue
        if cut is None:
            # Each layer's block drawn straight into its row of the stack.
            stacked = torch.empty((L, *shape), device=device, dtype=dtype)
            for i in range(L):
                _fill(stacked[i], seed, path, i, std)
        else:
            blocks = []
            for i in range(L):
                blocks.append(cut(path, draw_leaf(cfg, seed, path, i, device, dtype)).clone())
            stacked = torch.stack(blocks)
            del blocks
        _put(tree, path, stacked)
    return tree


@torch.no_grad()
def layer(cfg: dict, seed: int, i: int, device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Layer i's weights, drawn again from the seed (for the reference)."""
    tree: dict = {}
    for path in leaves(cfg):
        if path not in GLOBAL:
            _put(tree, path.split(".", 1)[1], draw_leaf(cfg, seed, path, i, device, dtype))
    return tree


@torch.no_grad()
def globals_(cfg: dict, seed: int, device, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The leaves outside the layers, drawn again from the seed."""
    return {p: draw_leaf(cfg, seed, p, 0, device, dtype) for p in leaves(cfg) if p in GLOBAL}


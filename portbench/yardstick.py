"""The benchmark's arithmetic: exact quantiles, the H100's peaks, model
FLOPs from real lengths, and the bytes one decode-attention call needs.

Nothing here reads the program: the counts come from the configuration
file and from the traffic's own lengths and positions.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def quantile(values, q: float) -> float:
    """The q-quantile of all the values, linear between order statistics
    (numpy's default). Raises on an empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    h = (len(xs) - 1) * q
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def dims(cfg: dict) -> dict:
    """The sizes the counts need, from a configuration file's keys."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(L=cfg["num_hidden_layers"], D=D, H=H, Hkv=cfg["num_key_value_heads"],
                Dh=cfg.get("head_dim") or D // H, F=cfg["intermediate_size"],
                V=cfg["vocab_size"], E=cfg.get("num_local_experts", 0),
                K=cfg.get("num_experts_per_tok", 0))


def matmul_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies through the layers: attention's four
    projections and, dense, the three MLP matrices; MoE, the router and
    the three matrices of each of its top-k experts. The output head is
    counted apart (``head_params``): only a token whose logits are used
    needs it."""
    d = dims(cfg)
    attn = d["D"] * (d["H"] + 2 * d["Hkv"]) * d["Dh"] + d["H"] * d["Dh"] * d["D"]
    mlp = 3 * d["D"] * d["F"]
    if d["E"]:
        mlp = d["K"] * mlp + d["D"] * d["E"]
    return d["L"] * (attn + mlp)


def head_params(cfg: dict) -> int:
    d = dims(cfg)
    return d["D"] * d["V"]


def attention_flops(cfg: dict, context: int) -> float:
    """Attention FLOPs of one query row over ``context`` keys, all layers:
    q·k and p·v, two FLOPs a multiply-add."""
    d = dims(cfg)
    return 4.0 * d["L"] * d["H"] * d["Dh"] * context


def prefill_flops(cfg: dict, n: int) -> float:
    """A fresh prompt of n tokens: the projections for each row, causal
    attention (row i sees i + 1 keys) and one row through the head."""
    causal = 4.0 * dims(cfg)["L"] * dims(cfg)["H"] * dims(cfg)["Dh"] * n * (n + 1) / 2
    return 2.0 * matmul_params_per_token(cfg) * n + causal + 2.0 * head_params(cfg)


def decode_flops(cfg: dict, position: int) -> float:
    """One decode token fed at ``position``: the projections, attention
    over positions 0..position, and the head."""
    return (2.0 * (matmul_params_per_token(cfg) + head_params(cfg))
            + attention_flops(cfg, position + 1))


def k1_bytes(cfg: dict, position: int, itemsize: int = 2) -> int:
    """Bytes that the decode-attention kernel needs for one active slot at
    ``position`` over all layers: its q row, its K and V rows 0..position
    and its output row, each read or written once."""
    d = dims(cfg)
    kv = 2 * (position + 1) * d["Hkv"] * d["Dh"]
    q_out = 2 * d["H"] * d["Dh"]
    return d["L"] * (kv + q_out) * itemsize

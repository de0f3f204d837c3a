"""The benchmark's arithmetic: exact quantiles, the H100's peaks, and
the counts of the cell's family (``portbench/families``): model FLOPs
from real lengths, and the bytes one decode-attention call needs.

Nothing here reads the program: the counts come from the configuration
file and from the traffic's own lengths and positions.
"""

from __future__ import annotations

import math

from portbench import families

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
    """The sizes the family's counts read, where it names them."""
    return families.of(cfg).dims(cfg)


def matmul_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies through the layers, the head apart."""
    return families.of(cfg).matmul_params_per_token(cfg)


def head_params(cfg: dict) -> int:
    return families.of(cfg).head_params(cfg)


def prefill_flops(cfg: dict, n: int) -> float:
    """A fresh prompt of n tokens."""
    return families.of(cfg).prefill_flops(cfg, n)


def decode_flops(cfg: dict, position: int) -> float:
    """One decode token fed at ``position``."""
    return families.of(cfg).decode_flops(cfg, position)


def decode_attention_bytes(cfg: dict, position: int, itemsize: int = 2) -> int:
    """Bytes that decode attention needs for one active slot at
    ``position``, over all layers."""
    return families.of(cfg).decode_attention_bytes(cfg, position, itemsize)


# K1 is the port's decode-attention kernel; ``k1_roofline`` reads its bytes so.
k1_bytes = decode_attention_bytes

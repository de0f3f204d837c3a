"""Normalization ops (port of ``omnia_tpu/ops/norms.py``).

Statistics in float32 whatever the input dtype, cast back to it."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: x / rms(x) * weight, reduction over the last axis."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)

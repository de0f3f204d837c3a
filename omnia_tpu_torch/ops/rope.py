"""Rotary position embeddings (port of ``omnia_tpu/ops/rope.py``).

Rotate-half convention; angles are computed in float32 from integer
positions (never accumulated), so large decode positions stay exact."""

from __future__ import annotations

import math

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: tuple | None = None):
    """positions: int tensor [...] → (cos, sin) float32 [..., head_dim//2].

    ``scaling`` is the llama3 long-context remap (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings); None = plain."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is not None:
        inv_freq = _llama3_scaled_inv_freq(inv_freq, *scaling)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _llama3_scaled_inv_freq(inv_freq: torch.Tensor, factor: float,
                            low_freq_factor: float, high_freq_factor: float,
                            original_max_position: float) -> torch.Tensor:
    """Llama-3.1 'llama3' rope_type: long wavelengths are slowed by
    ``factor``, short ones kept, the band between blends smoothly."""
    wavelen = 2.0 * math.pi / inv_freq
    low_wavelen = original_max_position / low_freq_factor
    high_wavelen = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smooth = smooth.clamp(0.0, 1.0)
    blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return torch.where(
        wavelen > low_wavelen,
        inv_freq / factor,
        torch.where(wavelen < high_wavelen, inv_freq, blended),
    )


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., H, head_dim]; cos/sin: [..., head_dim//2] (broadcast over H)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

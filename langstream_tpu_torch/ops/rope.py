"""Rotary position embeddings (RoPE), Llama-3 style."""

from __future__ import annotations

import math
from typing import Optional

import torch


def _llama3_scale_inv_freq(
    inv_freq: torch.Tensor,
    factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    original_max_positions: float,
) -> torch.Tensor:
    """Llama-3.1 NTK-by-parts frequency scaling (HF
    ``_compute_llama3_parameters``): high-frequency components keep
    their wavelength, low-frequency ones stretch by ``factor``, and the
    band between interpolates smoothly."""
    low_wavelen = original_max_positions / low_freq_factor
    high_wavelen = original_max_positions / high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / factor
    smooth = (
        original_max_positions / wavelen - low_freq_factor
    ) / (high_freq_factor - low_freq_factor)
    smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
    return torch.where(
        wavelen < high_wavelen,
        inv_freq,
        torch.where(wavelen > low_wavelen, scaled, smoothed),
    )


def rope_frequencies(
    head_dim: int,
    max_positions: int,
    theta: float = 500000.0,
    dtype: torch.dtype = torch.float32,
    scaling: Optional[tuple] = None,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Precomputed angles as (cos, sin) stacked on a leading axis of size
    2: [2, max_positions, head_dim // 2]. ``scaling`` is the config's
    rope-scaling tuple ``("llama3", factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings)``; None = plain
    RoPE."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv_freq = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exponents)
    if scaling is not None:
        kind = scaling[0]
        if kind != "llama3":
            raise ValueError(f"unsupported rope scaling type: {kind!r}")
        inv_freq = _llama3_scale_inv_freq(inv_freq, *scaling[1:])
    positions = torch.arange(max_positions, dtype=torch.float32)
    angles = torch.outer(positions, inv_freq)
    freqs = torch.stack([torch.cos(angles), torch.sin(angles)]).to(dtype)
    return freqs.to(device)


def apply_rope(
    x: torch.Tensor,
    freqs: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Rotate ``x`` of shape [..., seq, heads, head_dim] by the angles at
    ``positions`` [..., seq] (rotate_half layout: first half / second
    half)."""
    cos = freqs[0][positions].unsqueeze(-2)  # [..., seq, 1, head_dim//2]
    sin = freqs[1][positions].unsqueeze(-2)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)

"""Normalization ops."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    eps: float = 1e-5,
    plus_one: bool = False,
) -> torch.Tensor:
    """RMSNorm with f32 accumulation regardless of input dtype.
    ``plus_one`` selects the zero-centered weight convention (Gemma: the
    checkpoint stores w and the norm applies 1 + w)."""
    x32 = x.float()
    variance = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(variance + eps)
    w32 = weight.float()
    if plus_one:
        w32 = 1.0 + w32
    return (normed * w32).to(x.dtype)

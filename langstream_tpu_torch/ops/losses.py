"""Training and scoring losses.

Port of ``langstream_tpu/ops/losses.py``.
"""

from __future__ import annotations

import torch


def causal_ce_loss(
    logits: torch.Tensor,  # [B, T, V]
    tokens: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,    # [B, T] valid-token mask
) -> torch.Tensor:
    """Next-token cross-entropy, mean over valid target positions: the
    log-softmax in f32 over ``logits[:, :-1]``, each target's log
    probability, summed over the targets ``mask[:, 1:]`` keeps and divided
    by their count (at least 1, so an all-masked batch gives 0)."""
    targets = tokens[:, 1:].long()
    valid = mask[:, 1:].float()
    log_probs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_ll = torch.gather(log_probs, -1, targets[..., None])[..., 0]
    total = torch.clamp_min(valid.sum(), 1.0)
    return -(token_ll * valid).sum() / total

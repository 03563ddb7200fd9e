"""Training and scoring losses.

Port of ``langstream_tpu/ops/losses.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from langstream_tpu_torch.parallel.collectives import all_reduce_sum


def causal_ce_loss(
    logits: torch.Tensor,  # [B, T, V]
    tokens: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,    # [B, T] valid-token mask
    group: Optional[Any] = None,
) -> torch.Tensor:
    """Next-token cross-entropy, mean over valid target positions: the
    log-softmax in f32 over ``logits[:, :-1]``, each target's log
    probability, summed over the targets ``mask[:, 1:]`` keeps and divided
    by their count (at least 1, so an all-masked batch gives 0).

    With ``group`` (the batch axes' ``parallel.mesh.AxisGroup``, each rank
    holding its rows of the global batch) the count is every rank's, so
    the ranks' losses add up to the global mean: each rank's own mean
    would weigh its rows wrongly wherever the masks differ."""
    nll, count = causal_nll_sum(logits, tokens, mask)
    if group is not None:
        count = all_reduce_sum(group, count)
    return nll / torch.clamp_min(count, 1.0)


def causal_nll_sum(logits: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor):
    """(the summed negative log likelihood of the valid next-token
    targets, their count): :func:`causal_ce_loss`'s numerator and
    denominator."""
    targets = tokens[:, 1:].long()
    valid = mask[:, 1:].float()
    log_probs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_ll = torch.gather(log_probs, -1, targets[..., None])[..., 0]
    return -(token_ll * valid).sum(), valid.sum()

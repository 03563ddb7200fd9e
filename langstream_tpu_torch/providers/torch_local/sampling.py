"""On-device sampling: port of the JAX engine's ``_sample``,
``_truncation_mask`` and ``_token_logprob`` (``engine.py``).

Greedy where temperature is 0, else a temperature softmax sample with
optional top-k / top-p truncation as a ``-inf`` mask. The noise comes
from ``prng.py``, which reproduces ``jax.random`` bit for bit, so a
seeded request draws the same tokens as on the JAX engine. The tiers only
decide what is computed: greedy-only batches skip the noise, and batches
with no truncation skip the sort.
"""

from __future__ import annotations

from typing import Optional

import torch

from langstream_tpu_torch.providers.torch_local import prng


def truncation_mask(
    logits: torch.Tensor,            # [S, V]
    top_k: torch.Tensor,             # [S] (0 = disabled)
    top_p: Optional[torch.Tensor],   # [S] (0 = disabled)
) -> torch.Tensor:
    """Top-k / top-p truncation as a -inf mask over the logits."""
    vocab = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.clamp(top_k.long(), 0, vocab)
    kth_index = torch.clamp(k - 1, 0, vocab - 1)
    kth_value = torch.gather(sorted_logits, 1, kth_index[:, None])
    neg_inf = torch.full_like(logits, float("-inf"))
    masked = torch.where((k[:, None] > 0) & (logits < kth_value), neg_inf, logits)
    if top_p is not None:
        # nucleus: keep the smallest set of tokens whose mass >= p
        probs = torch.softmax(sorted_logits, dim=-1)
        cumulative = torch.cumsum(probs, dim=-1)
        inside = cumulative - probs < top_p[:, None]
        cut = torch.where(
            inside, sorted_logits, torch.full_like(sorted_logits, float("inf"))
        ).amin(dim=-1)
        masked = torch.where(
            (top_p[:, None] > 0) & (masked < cut[:, None]), neg_inf, masked
        )
    return masked


def sample(
    logits: torch.Tensor,        # [S, V] f32
    temperature: torch.Tensor,   # [S]
    top_k: torch.Tensor,         # [S]
    key: prng.Key,               # per-slot keys (prng.sampling_keys)
    top_p: Optional[torch.Tensor] = None,
    *,
    stochastic: bool,
    truncated: bool,
) -> torch.Tensor:
    """Per-slot sampling: greedy where temperature == 0, else a sample
    from the (optionally truncated) temperature softmax. ``stochastic`` /
    ``truncated`` say whether ANY row has temperature > 0 / truncation —
    the caller knows them from the host-side request parameters, so
    deciding the tier costs no device sync."""
    greedy = torch.argmax(logits, dim=-1)
    if not stochastic:
        return greedy
    scaled = truncation_mask(logits, top_k, top_p) if truncated else logits
    scaled = scaled / torch.clamp_min(temperature, 1e-6)[:, None]
    sampled = prng.categorical(key, scaled)
    return torch.where(temperature > 0, sampled, greedy)


def token_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """logits[token] - logsumexp(logits), in f32."""
    logits32 = logits.float()
    picked = torch.gather(logits32, 1, token.long()[:, None])[:, 0]
    return picked - torch.logsumexp(logits32, dim=-1)

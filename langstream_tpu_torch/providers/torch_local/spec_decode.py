"""Self-drafting speculative decoding: the prompt-lookup drafter and the
acceptance pass, in tensor code that runs inside the engine's step graph.

Port of ``langstream_tpu/providers/jax_local/spec_decode.py``. A decode
step drafts up to ``k`` tokens per slot from the slot's own token history
(:func:`draft_ngram`), one verify call (``model.verify_step`` or
``model.paged_verify_step``) scores the ``1 + k`` block at every
position, and :func:`accept_block` emits every candidate the model itself
would have produced: greedy rows accept a candidate iff it is the argmax,
sampled rows run rejection sampling against the distribution
``sampling.sample`` draws from. Penalties and logit bias apply position by
position with the counts updated as candidates are accepted, and the key
of emission ``i`` is ``prng.sampling_keys(seeds, base_lengths + i)``, as
in the plain decode chunk, so a slot with no draft reproduces a plain
step bit for bit. The accept and residual noise derives from that key by
``fold_in`` 1 and 2, as in JAX, through ``prng``, so the uniforms are
JAX's bit for bit.

The JAX acceptance picks its branches with ``lax.cond`` (any row sampled;
any row truncated). A CUDA graph cannot branch, so the caller passes the
batch's host-known tier (``stochastic``, ``truncated``: the flags of
``graphs.TIERS``); the computed tokens are the same. Rollback needs no
work here: a rejected draft's KV rows sit past the accepted length, where
no attention reads them, and a later step overwrites them in order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from langstream_tpu_torch.providers.torch_local import prng, sampling


def draft_ngram(
    history: torch.Tensor,   # [S, T] int32: the token at cache position t
    lengths: torch.Tensor,   # [S] valid history INCLUDING the pending token
    active: torch.Tensor,    # [S] bool
    *,
    ngram: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup drafting: per slot, match the trailing ``ngram``
    tokens against the history and propose the ``k`` tokens that followed
    the most recent earlier match. Returns (drafts [S, k] int64, drafted
    counts [S] int32); a count is 0 where nothing matches (the verify step
    is then a plain decode step)."""
    slots, width = history.shape
    device = history.device
    idx = torch.arange(width, device=device)
    lengths = lengths.long()
    pat_pos = (lengths[:, None] - ngram + torch.arange(ngram, device=device)[None, :]).clamp(0, width - 1)
    pattern = torch.gather(history, 1, pat_pos)  # [S, n]
    match = torch.ones((slots, width), dtype=torch.bool, device=device)
    for j in range(ngram):
        # h[i + j] aligned at i; wrapped values are masked below (a valid
        # start needs i + n < L <= width, so it never wraps)
        match = match & (torch.roll(history, -j, dims=1) == pattern[:, j:j + 1])
    # a start i needs the n-gram inside the valid prefix and at least one
    # continuation token before the pending position (i + n < L), which
    # also excludes the trailing n-gram's match with itself
    match = match & ((idx[None, :] + ngram) < lengths[:, None])
    match = match & (lengths[:, None] >= ngram + 1) & active[:, None]
    best = torch.where(match, idx[None, :], torch.full_like(match, -1, dtype=torch.long)).amax(dim=1)
    found = best >= 0
    source = (best[:, None] + ngram + torch.arange(k, device=device)[None, :]).clamp(0, width - 1)
    drafts = torch.gather(history, 1, source).long()
    num = torch.where(found, (lengths - (best + ngram)).clamp(0, k), torch.zeros_like(best))
    # drafted KV writes reach position L - 1 + num, inside the cache width
    num = torch.minimum(num, (width - lengths).clamp(min=0))
    return drafts, num.to(torch.int32)


def _accept_or_fallback(
    adjusted: torch.Tensor,     # [S, V] penalty/bias-adjusted logits
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,        # [S]
    top_p: torch.Tensor,        # [S]
    keys: prng.Key,             # the slots' keys at this position
    candidate: torch.Tensor,    # [S] drafted token here
    have: torch.Tensor,         # [S] bool: a draft exists here
    *,
    stochastic: bool,
    truncated: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position accept decision and the token to emit on rejection (or
    where no draft exists). Greedy rows accept iff the candidate is the
    argmax and fall back to it; sampled rows accept with probability
    p(candidate) under the truncated, temperature-scaled distribution
    ``sampling.sample`` draws from and fall back to a draw from the
    residual (p with the candidate removed)."""
    greedy = torch.argmax(adjusted, dim=-1)
    if not stochastic:
        return (greedy == candidate) & have, greedy
    vocab = adjusted.shape[-1]
    # one truncation sort per position, shared by the fallback sampler and
    # the acceptance probabilities
    masked = sampling.truncation_mask(adjusted, top_k, top_p) if truncated else adjusted
    plain = sampling.sample(adjusted, temperature, top_k, keys, top_p, stochastic=True,
                            truncated=truncated, masked=masked)
    scaled = masked / torch.clamp_min(temperature, 1e-6)[:, None]
    logz = torch.logsumexp(scaled, dim=-1)
    cand = candidate.long().clamp(0, vocab - 1)
    logp = torch.gather(scaled, 1, cand[:, None])[:, 0] - logz
    ones = torch.ones_like(keys[0])
    uniforms = prng.unit_uniform(prng.fold_in(keys, ones))
    # a draft outside the truncation set has logp = -inf: always rejected
    accepted = torch.log(torch.clamp_min(uniforms, 1e-38)) < logp
    residual = scaled.scatter(1, cand[:, None], float("-inf"))
    resampled = prng.categorical(prng.fold_in(keys, 2 * ones), residual)
    rows = temperature > 0
    accept = torch.where(rows, accepted, greedy == candidate) & have
    fallback = torch.where(rows & have, resampled, plain)
    return accept, fallback


def accept_block(
    logits: torch.Tensor,       # [S, B, V] raw verify logits
    block: torch.Tensor,        # [S, B] verified tokens (pending + drafts)
    num_drafted: torch.Tensor,  # [S]
    counts: torch.Tensor,       # [S, V] int32 penalty counts, updated IN PLACE
    active: torch.Tensor,       # [S] bool
    x: dict,                    # the step's sampling tensors (temperature,
                                # top_k, top_p, seeds, presence, frequency
                                # [S, 1], bias_ids, bias_vals)
    base_lengths: torch.Tensor,  # [S] lengths at block entry: the key
                                 # position of emission 0
    *,
    stochastic: bool,
    truncated: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential accept/reject over a verified block. Emission ``i``
    draws from ``logits[:, i]`` (penalties and bias with the counts as of
    that position) and checks the candidate ``block[:, i + 1]``; the first
    rejection emits the fallback and ends the slot's block. Returns
    (emitted [S, B], logprobs [S, B] under the raw logits, valid [S, B]: a
    True-prefix mask of the emitted positions)."""
    slots, width, _ = logits.shape
    candidates = torch.cat([block[:, 1:], torch.zeros_like(block[:, :1])], dim=1)
    alive = torch.ones(slots, dtype=torch.bool, device=logits.device)
    emitted, lps, valids = [], [], []
    for i in range(width):
        raw = logits[:, i].float()
        adjusted = raw - x["presence"] * (counts > 0) - x["frequency"] * counts
        adjusted = adjusted.scatter_add(1, x["bias_ids"], x["bias_vals"])
        keys = prng.sampling_keys(x["seeds"], base_lengths + i)
        have = (i < num_drafted) & active
        accepted, fallback = _accept_or_fallback(
            adjusted, x["temperature"], x["top_k"], x["top_p"], keys, candidates[:, i], have,
            stochastic=stochastic, truncated=truncated,
        )
        emit = torch.where(have & accepted, candidates[:, i], fallback)
        emit = torch.where(active, emit, torch.zeros_like(emit))
        valid = alive & active
        lps.append(sampling.token_logprob(raw, emit))
        counts.scatter_add_(1, emit[:, None], valid.to(torch.int32)[:, None])
        alive = alive & have & accepted
        emitted.append(emit)
        valids.append(valid)
    return torch.stack(emitted, dim=1), torch.stack(lps, dim=1), torch.stack(valids, dim=1)

"""Plain attention ops for prefill and decode (GQA).

These are the PyTorch compositions of the two attention functions the
serving path runs. They are the CPU path and the reference the CUDA
kernels (``flash_attention.py``, ``decode_kernel.py``) are held against;
nothing on the main path calls them when the tensors live on the card.

Conventions: q/k/v are [batch, seq, heads, head_dim]; the KV cache is
[batch, max_len, kv_heads, head_dim]; GQA groups queries by kv head
(G = H // KVH) by reshaping, never by copying kv heads.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _group_query(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, T, H, D] → [B, T, KVH, G, D] grouping queries by kv head."""
    batch, seq, heads, dim = q.shape
    return q.reshape(batch, seq, kv_heads, heads // kv_heads, dim)


def _cap_scores(scores: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """Logit softcapping (Gemma-2): cap·tanh(s/cap), applied BEFORE
    masking."""
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    return scores


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    scores = scores - torch.amax(scores, dim=-1, keepdim=True)
    exp = torch.exp(scores)
    return exp / torch.sum(exp, dim=-1, keepdim=True)


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention over a full (padded) prompt.

    q: [B, T, H, D], k/v: [B, T, KVH, D] → [B, T, H, D]. ``mask`` [B, T]
    marks valid tokens; ``window`` (0/None = full) restricts each query to
    the last ``window`` positions; ``scale`` overrides head_dim**-0.5."""
    batch, seq, heads, dim = q.shape
    kv_heads = k.shape[2]
    scale = dim ** -0.5 if scale is None else scale
    qg = _group_query(q, kv_heads)
    scores = torch.einsum(
        "bqkgd,bskd->bkgqs", qg.float(), k.float()
    ) * scale  # [B, KVH, G, Tq, Ts]
    scores = _cap_scores(scores, softcap)
    rows = torch.arange(seq, device=q.device)[:, None]
    cols = torch.arange(seq, device=q.device)[None, :]
    allowed = cols <= rows
    if window is not None and window > 0:
        allowed = allowed & (cols > rows - window)
    allowed = allowed[None, None, None]
    if mask is not None:
        allowed = allowed & mask[:, None, None, None, :].bool()
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
    weights = _softmax(scores)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights.to(v.dtype), v)
    return out.reshape(batch, seq, heads, dim)


def _decode_valid(
    max_len: int,
    lengths: torch.Tensor,
    window: Optional[int],
) -> torch.Tensor:
    """[B, T] validity for one-token decode: live rows, optionally
    restricted to the query's sliding window (query pos = lengths-1)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    valid = pos < lengths[:, None]
    if window is not None and window > 0:
        valid = valid & (pos > (lengths[:, None] - 1) - window)
    return valid


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode attention against the cache.

    q: [B, H, D], k/v_cache: [B, T, KVH, D], lengths: [B] valid cache
    entries (including the new token, already written at lengths-1).
    Returns [B, H, D]."""
    batch, heads, dim = q.shape
    max_len, kv_heads = k_cache.shape[1], k_cache.shape[2]
    scale = dim ** -0.5 if scale is None else scale
    qg = q.reshape(batch, kv_heads, heads // kv_heads, dim)
    scores = torch.einsum(
        "bkgd,bskd->bkgs", qg.float(), k_cache.float()
    ) * scale  # [B, KVH, G, T]
    scores = _cap_scores(scores, softcap)
    valid = _decode_valid(max_len, lengths, window)
    scores = torch.where(
        valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF)
    )
    weights = _softmax(scores)
    out = torch.einsum("bkgs,bskd->bkgd", weights.to(v_cache.dtype), v_cache)
    return out.reshape(batch, heads, dim)

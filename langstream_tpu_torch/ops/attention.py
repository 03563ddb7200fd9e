"""Plain attention ops for prefill, prefill-at-offset and decode (GQA),
over the dense cache and the paged block pool, in the model's dtype or
over an int8 cache with per-(position, kv head) scales.

These are the PyTorch compositions of the attention functions the serving
paths run. They are the CPU path and the reference the CUDA kernels
(``flash_attention.py``, ``decode_kernel.py``, ``paged_attention.py``) are
held against; on the card the serving paths call the kernels instead,
except for dense prefill-at-offset (:func:`chunk_attention`), which the
JAX package also leaves to its compiler, and the paged scatter
(:func:`paged_write_rows`).

Conventions: q/k/v are [batch, seq, heads, head_dim]; the KV cache is
[batch, max_len, kv_heads, head_dim]; GQA groups queries by kv head
(G = H // KVH) by reshaping, never by copying kv heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def chunk_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefill-at-offset attention against the cache.

    q: [B, T, H, D] — T new tokens per row whose global positions are
    ``starts[b] + t``; k/v_cache: [B, S, KVH, D] with the new tokens' KV
    already written at ``starts[b]..starts[b]+n-1``; lengths: [B] total
    valid cache entries (starts + new tokens). Query t attends causally
    to cache positions ``<= starts[b] + t`` below ``lengths[b]``.
    Returns [B, T, H, D]. Plain PyTorch on every device: the JAX package
    leaves this op to XLA too."""
    batch, seq, heads, dim = q.shape
    max_len, kv_heads = k_cache.shape[1], k_cache.shape[2]
    scale = dim ** -0.5 if scale is None else scale
    qg = _group_query(q, kv_heads)  # [B, Tq, KVH, G, D]
    scores = torch.einsum(
        "bqkgd,bskd->bkgqs", qg.float(), k_cache.float()
    ) * scale  # [B, KVH, G, Tq, S]
    scores = _cap_scores(scores, softcap)
    pos_q = starts[:, None] + torch.arange(seq, device=q.device)[None, :]  # [B, Tq]
    pos_s = torch.arange(max_len, device=q.device)[None, None, :]          # [1, 1, S]
    allowed = (pos_s <= pos_q[:, :, None]) & (pos_s < lengths[:, None, None])
    if window is not None and window > 0:
        allowed = allowed & (pos_s > pos_q[:, :, None] - window)
    scores = torch.where(
        allowed[:, None, None], scores, torch.full_like(scores, NEG_INF)
    )
    weights = _softmax(scores)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights.to(v_cache.dtype), v_cache)
    return out.reshape(batch, seq, heads, dim)


# ---------------------------------------------------------------------- #
# paged KV cache (kv_layout="paged")
# ---------------------------------------------------------------------- #
# The cache is a block pool [num_blocks, block_size, kv_heads, head_dim]
# addressed through per-slot block tables [B, M]: token position p of row
# b lives in pool block ``table[b, p // block_size]`` at offset
# ``p % block_size``. Block 0 is the null block: tables route padding and
# masked writes there, and no live length ever lets attention read it.
# The functions below gather a row-contiguous view through the tables and
# reuse the dense formulas. They are the plain versions of the ragged
# paged-attention kernel (``ops/paged_attention.py``), which reads the
# tables itself and never materializes the gathered copy.


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[N, Bs, ...] pool + [B, M] tables → [B, M*Bs, ...] contiguous
    per-row view (a copy)."""
    view = pool[block_tables.long()]  # [B, M, Bs, ...]
    return view.reshape(view.shape[0], view.shape[1] * view.shape[2], *view.shape[3:])


def paged_write_rows(
    pool: torch.Tensor,          # [N, Bs, ...]
    new: torch.Tensor,           # [B, T, ...]
    block_tables: torch.Tensor,  # [B, M]
    offsets: torch.Tensor,       # [B] global position of each row's token 0
    valid: torch.Tensor,         # [B, T] bool; False routes to the null block
) -> torch.Tensor:
    """Scatter per-token rows into their table-addressed pool blocks, IN
    PLACE, and return ``pool``. Invalid rows (padding, masked decode
    slots) land in the null block, whose content is never read; so do
    positions past the table's capacity (``pos // block_size >= M``),
    which a clamped table index would otherwise land in the row's last
    real block, over live rows another chain may still reference.
    Several masked rows may hit the same null-block row; which write
    wins does not matter."""
    seq = new.shape[1]
    block_size = pool.shape[1]
    capacity = block_tables.shape[1]
    pos = offsets.long()[:, None] + torch.arange(seq, device=new.device)[None, :]  # [B, T]
    seq_block = torch.div(pos, block_size, rounding_mode="floor")
    blocks = torch.gather(block_tables.long(), 1, seq_block.clamp(0, capacity - 1))
    in_table = (seq_block >= 0) & (seq_block < capacity)
    blocks = torch.where(valid.bool() & in_table, blocks, torch.zeros_like(blocks))
    pool[blocks, pos % block_size] = new.to(pool.dtype)
    return pool


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`decode_attention` over a block pool: gather each row's
    blocks into a contiguous [B, M*Bs, KVH, D] view, then the dense
    formula (lengths mask out the tail, null-block rows included)."""
    return decode_attention(
        q, gather_blocks(k_pool, block_tables), gather_blocks(v_pool, block_tables),
        lengths, softcap=softcap, window=window, scale=scale,
    )


def paged_chunk_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`chunk_attention` over a block pool (prefill-at-offset onto
    a cached prefix some other request's prefill wrote)."""
    return chunk_attention(
        q, gather_blocks(k_pool, block_tables), gather_blocks(v_pool, block_tables),
        starts, lengths, softcap=softcap, window=window, scale=scale,
    )


# ---------------------------------------------------------------------- #
# int8 KV cache (kv_quant="int8")
# ---------------------------------------------------------------------- #
# The cache stores int8 values with one f32 scale per (position, kv head).
# Per-row scales commute with both attention contractions, so neither
# touches a dequantized cache-sized tensor:
#   q·kᵀ: q · (K_q * s)ᵀ = (q · K_qᵀ) * s   (s scales the score columns)
#   p·v:  p · (V_q * s)  = (p * s) · V_q    (s folds into the probabilities,
#                                           after they are normalized)
# The softmax sums the probabilities before the v-scale fold. p·v runs in
# f32 with the int8 values as f32 (exact), and the output takes q's dtype.


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x [..., D] → (int8 values [..., D], f32
    scales [...]) with scale = max(amax, 1e-8) / 127 over the head dim.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def decode_attention_quant(
    q: torch.Tensor,
    k_cache: torch.Tensor,  # [B, T, KVH, D] int8
    k_scale: torch.Tensor,  # [B, T, KVH] f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`decode_attention` over an int8 cache (the algebra above)."""
    batch, heads, dim = q.shape
    max_len, kv_heads = k_cache.shape[1], k_cache.shape[2]
    scale = dim ** -0.5 if scale is None else scale
    qg = q.reshape(batch, kv_heads, heads // kv_heads, dim)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    scores = scores * k_scale.float().transpose(1, 2)[:, :, None, :] * scale
    scores = _cap_scores(scores, softcap)
    valid = _decode_valid(max_len, lengths, window)
    scores = torch.where(
        valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF)
    )
    weights = _softmax(scores) * v_scale.float().transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", weights, v_cache.float())
    return out.reshape(batch, heads, dim).to(q.dtype)


def chunk_attention_quant(
    q: torch.Tensor,
    k_cache: torch.Tensor,  # [B, S, KVH, D] int8
    k_scale: torch.Tensor,  # [B, S, KVH] f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`chunk_attention` over an int8 cache. With ``starts = 0`` it
    is cold prefill's self-attention over the just-quantized prompt, the
    plain version of the int8 flash-prefill kernel."""
    batch, seq, heads, dim = q.shape
    max_len, kv_heads = k_cache.shape[1], k_cache.shape[2]
    scale = dim ** -0.5 if scale is None else scale
    qg = _group_query(q, kv_heads)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float())
    scores = scores * k_scale.float().transpose(1, 2)[:, :, None, None, :] * scale
    scores = _cap_scores(scores, softcap)
    pos_q = starts[:, None] + torch.arange(seq, device=q.device)[None, :]
    pos_s = torch.arange(max_len, device=q.device)[None, None, :]
    allowed = (pos_s <= pos_q[:, :, None]) & (pos_s < lengths[:, None, None])
    if window is not None and window > 0:
        allowed = allowed & (pos_s > pos_q[:, :, None] - window)
    scores = torch.where(
        allowed[:, None, None], scores, torch.full_like(scores, NEG_INF)
    )
    weights = _softmax(scores) * v_scale.float().transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v_cache.float())
    return out.reshape(batch, seq, heads, dim).to(q.dtype)


def paged_decode_attention_quant(
    q: torch.Tensor,
    k_pool: torch.Tensor,        # [N, Bs, KVH, D] int8
    k_scale: torch.Tensor,       # [N, Bs, KVH] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Int8-pool twin of :func:`paged_decode_attention`: the scales
    gather through the same tables as the values."""
    return decode_attention_quant(
        q,
        gather_blocks(k_pool, block_tables), gather_blocks(k_scale, block_tables),
        gather_blocks(v_pool, block_tables), gather_blocks(v_scale, block_tables),
        lengths, softcap=softcap, window=window, scale=scale,
    )


def paged_chunk_attention_quant(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Int8-pool twin of :func:`paged_chunk_attention`."""
    return chunk_attention_quant(
        q,
        gather_blocks(k_pool, block_tables), gather_blocks(k_scale, block_tables),
        gather_blocks(v_pool, block_tables), gather_blocks(v_scale, block_tables),
        starts, lengths, softcap=softcap, window=window, scale=scale,
    )


# ---------------------------------------------------------------------- #
# token-ragged q (the mixed prefill+decode step)
# ---------------------------------------------------------------------- #
def _ragged_q_spans(chunk, q, leaves, block_tables, starts, lengths, q_offsets, max_q_len,
                    block_q, family) -> torch.Tensor:
    """Un-flatten each row's span of the [Q, H, D] tile (``max_q_len``
    tokens at ``q_offsets[b]``) to [B, max_q_len, H, D], run ``chunk`` over
    it, zero the q tiles past each row's live count ``lengths - starts``,
    and write the spans back into a zero [Q, H, D] tile."""
    span = q_offsets.long()[:, None] + torch.arange(max_q_len, device=q.device)[None, :]
    rows = chunk(q[span], *leaves, block_tables, starts, lengths, **family)
    live = (lengths - starts).clamp(min=0)
    tile_start = torch.arange(max_q_len, device=q.device) // block_q * block_q
    dead = tile_start[None, :] >= live[:, None]
    out = torch.zeros_like(q)
    out[span] = rows.masked_fill(dead[:, :, None, None], 0).to(q.dtype)
    return out


def paged_ragged_q_attention(
    q: torch.Tensor,             # [Q, H, D] flat new-token tile
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M]
    starts: torch.Tensor,        # [B]
    lengths: torch.Tensor,       # [B] TOTAL live context
    q_offsets: torch.Tensor,     # [B] row offsets into q
    *,
    max_q_len: int,
    block_q: int,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`paged_chunk_attention` over the token-ragged layout: row
    ``b``'s queries are the ``max_q_len`` tokens at ``q_offsets[b]`` of the
    flat tile, ``lengths[b] - starts[b]`` of them live. q tiles (of
    ``block_q``) past the live count, and positions no span covers, are
    zero."""
    return _ragged_q_spans(
        paged_chunk_attention, q, (k_pool, v_pool), block_tables, starts, lengths, q_offsets,
        max_q_len, block_q, dict(softcap=softcap, window=window, scale=scale),
    )


def paged_ragged_q_attention_quant(
    q: torch.Tensor,
    k_pool: torch.Tensor,        # [N, Bs, KVH, D] int8
    k_scale: torch.Tensor,       # [N, Bs, KVH] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    q_offsets: torch.Tensor,
    *,
    max_q_len: int,
    block_q: int,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Int8-pool twin of :func:`paged_ragged_q_attention`."""
    return _ragged_q_spans(
        paged_chunk_attention_quant, q, (k_pool, k_scale, v_pool, v_scale), block_tables,
        starts, lengths, q_offsets, max_q_len, block_q,
        dict(softcap=softcap, window=window, scale=scale),
    )

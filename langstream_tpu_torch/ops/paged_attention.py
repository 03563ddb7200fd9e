"""Ragged paged attention over the KV block pool: the CUDA kernel and its
wrapper.

Port of ``langstream_tpu/ops/paged_attention.py``. The TPU kernel
(``_ragged_kernel``, body ``_ragged_kernel_body``: a (row, q block, table
block) grid whose scalar-prefetched block tables address the pool in the
index maps, with blocks outside a tile's live range clamped so their DMA
is elided) becomes the Hopper kernel in ``csrc/paged_attention.cu``: one
CTA per (kv head, row, q tile) that reads its row's table, start and
length itself and walks only the table entries inside
:func:`block_bounds`. Its design note is at the top of that file.

One launch serves every case the paged engine dispatches: decode (Tq=1,
start = length-1), prefill-at-offset onto a cached prefix (start =
offset) and cold paged prefill (start = 0). Query token ``t`` of row
``b`` sits at ``starts[b] + t`` and attends causally at that position
over keys below ``lengths[b]`` (the row's TOTAL live context).

:func:`ragged_paged_attention` keeps the JAX API's shapes. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs the
plain version (:func:`~langstream_tpu_torch.ops.attention.
paged_chunk_attention`, or :func:`~langstream_tpu_torch.ops.attention.
paged_decode_attention` at Tq == 1).

:func:`ragged_paged_attention_quant` is the int8 twin
(``_ragged_kernel_quant``): int8 pools with one f32 scale per (block,
offset, kv head), reached through the same table entries, the same kernel
source instantiated for int8 tiles (entry point ``paged_attention_quant``);
plain versions ``paged_chunk_attention_quant`` and, at Tq == 1,
``paged_decode_attention_quant``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops.attention import (
    paged_chunk_attention,
    paged_chunk_attention_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
)

KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 256
# a CTA's tile holds at most this many score rows (query tokens x the
# query heads of one kv head); see the .cu
MAX_TILE_ROWS = 64


def last_live_block(total: int, block_size: int) -> int:
    """Index of the last block holding live rows (>= 0, so an empty row
    still maps block 0: fully masked, it yields zeros)."""
    return max(1, -(-total // block_size)) - 1


def block_bounds(
    start: int, total: int, window: int, q_first: int, q_count: int, block_size: int
) -> Tuple[int, int]:
    """[first, last] table-block range the q tile of queries ``q_first ..
    q_first + q_count - 1`` needs: the causal frontier of its last query
    and the row's length cap the top, a sliding window (of its first
    query) floors the bottom. The kernel computes the same bounds; this
    copy is what ``chip_smoke.py`` counts bytes with."""
    last = min(last_live_block(total, block_size), (start + q_first + q_count - 1) // block_size)
    last = max(last, 0)
    first = max(0, (start + q_first - window + 1) // block_size) if window > 0 else 0
    return min(first, last), last


def fused_shapes_ok(
    heads: int, kv_heads: int, dim: Optional[int] = None, quantized: bool = False
) -> bool:
    """Whether the kernel takes a config's shapes: query heads group
    evenly over kv heads, at most MAX_TILE_ROWS of them per kv head, and
    (when given) a head_dim up to 256 that is a multiple of 8, or of 16
    over int8 pools (``quantized``: one 16-byte load holds 16 values)."""
    if kv_heads <= 0 or heads % kv_heads != 0 or heads // kv_heads > MAX_TILE_ROWS:
        return False
    step = 16 if quantized else 8
    return dim is None or (dim % step == 0 and 0 < dim <= MAX_HEAD_DIM)


def _check_inputs(q, k_pool, v_pool, block_tables, starts, lengths) -> None:
    batch, _, heads, dim = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device {q.device}")
    for name, tensor in (
        ("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
        ("starts", starts), ("lengths", lengths),
    ):
        if tensor.device != q.device:
            raise ValueError(f"ragged_paged_attention: {name} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"ragged_paged_attention: q and the pools must share one of "
            f"{list(KERNEL_DTYPES)}, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != dim:
        raise ValueError(
            f"ragged_paged_attention: pools must be [N, Bs, KVH, D] matching q "
            f"{tuple(q.shape)}, got {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
        )
    if not fused_shapes_ok(heads, k_pool.shape[2], dim):
        raise ValueError(
            f"ragged_paged_attention: {heads} heads over {k_pool.shape[2]} kv heads "
            f"at head_dim {dim} (needs an even grouping of at most {MAX_TILE_ROWS} "
            f"and a head_dim that is a multiple of 8 up to {MAX_HEAD_DIM})"
        )
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or block_tables.shape[0] != batch:
        raise ValueError(
            f"ragged_paged_attention: block_tables must be int32 [{batch}, M], got "
            f"{block_tables.dtype} {tuple(block_tables.shape)}"
        )
    for name, tensor in (("starts", starts), ("lengths", lengths)):
        if tensor.dtype != torch.int32 or tensor.shape != (batch,):
            raise ValueError(
                f"ragged_paged_attention: {name} must be int32 [{batch}], got "
                f"{tensor.dtype} {tuple(tensor.shape)}"
            )
    for name, tensor in (
        ("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
        ("starts", starts), ("lengths", lengths),
    ):
        if not tensor.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be contiguous")
    for name, tensor in (("k_pool", k_pool), ("v_pool", v_pool)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"ragged_paged_attention: {name} must be 16-byte aligned")


def ragged_paged_attention(
    q: torch.Tensor,             # [B, Tq, H, D] (right-padded new tokens)
    k_pool: torch.Tensor,        # [N, Bs, KVH, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32 pool block per sequence block
    starts: torch.Tensor,        # [B] int32 global position of each row's query 0
    lengths: torch.Tensor,       # [B] int32 TOTAL live context (prefix + new)
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One launch over the block pool for decode, prefill-at-offset and
    cold paged prefill. Returns [B, Tq, H, D]. Outputs past a row's
    new-token count (``t >= lengths[b] - starts[b]``) are discarded by
    every caller: the kernel writes zeros for its q tiles wholly past it
    and never faults there. A row with no live key yields zeros on the
    card."""
    if q.device.type == "cpu":
        family = dict(softcap=softcap, window=window, scale=scale)
        if q.shape[1] == 1:
            return paged_decode_attention(
                q[:, 0], k_pool, v_pool, block_tables, lengths, **family
            )[:, None]
        return paged_chunk_attention(
            q, k_pool, v_pool, block_tables, starts, lengths, **family
        )
    _check_inputs(q, k_pool, v_pool, block_tables, starts, lengths)
    batch, seq, heads, dim = q.shape
    num_blocks, block_size, kv_heads = k_pool.shape[:3]
    lib = _build.load("paged_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
        batch, seq, heads, kv_heads, dim, num_blocks, block_size,
        block_tables.shape[1], KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), stream,
    )
    _build.check(status, "paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def _check_quant_inputs(q, k_pool, k_scale, v_pool, v_scale, block_tables, starts, lengths) -> None:
    name = "ragged_paged_attention_quant"
    batch, _, heads, dim = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    tensors = (
        ("k_pool", k_pool), ("k_scale", k_scale), ("v_pool", v_pool), ("v_scale", v_scale),
        ("block_tables", block_tables), ("starts", starts), ("lengths", lengths),
    )
    for label, tensor in tensors:
        if tensor.device != q.device:
            raise ValueError(f"{name}: {label} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: q must be one of {list(KERNEL_DTYPES)}, got {q.dtype}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"{name}: the pools must be int8, got {k_pool.dtype}/{v_pool.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != dim:
        raise ValueError(
            f"{name}: pools must be [N, Bs, KVH, D] matching q {tuple(q.shape)}, got "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
        )
    if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_pool.shape[:3]:
        raise ValueError(
            f"{name}: scales must be [N, Bs, KVH] {tuple(k_pool.shape[:3])}, got "
            f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}"
        )
    if not fused_shapes_ok(heads, k_pool.shape[2], dim, quantized=True):
        raise ValueError(
            f"{name}: {heads} heads over {k_pool.shape[2]} kv heads at head_dim {dim} "
            f"(needs an even grouping of at most {MAX_TILE_ROWS} and a head_dim that is "
            f"a multiple of 16 up to {MAX_HEAD_DIM})"
        )
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or block_tables.shape[0] != batch:
        raise ValueError(
            f"{name}: block_tables must be int32 [{batch}, M], got "
            f"{block_tables.dtype} {tuple(block_tables.shape)}"
        )
    for label, tensor in (("starts", starts), ("lengths", lengths)):
        if tensor.dtype != torch.int32 or tensor.shape != (batch,):
            raise ValueError(
                f"{name}: {label} must be int32 [{batch}], got {tensor.dtype} {tuple(tensor.shape)}"
            )
    for label, tensor in (("q", q),) + tensors:
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, tensor in (("k_pool", k_pool), ("v_pool", v_pool)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def ragged_paged_attention_quant(
    q: torch.Tensor,             # [B, Tq, H, D]
    k_pool: torch.Tensor,        # [N, Bs, KVH, D] int8
    k_scale: torch.Tensor,       # [N, Bs, KVH] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    starts: torch.Tensor,        # [B] int32
    lengths: torch.Tensor,       # [B] int32 TOTAL live context
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`ragged_paged_attention` over int8 pools. Returns [B, Tq, H,
    D] in q's dtype; the same callers' contract (outputs past a row's new
    tokens are discarded, a row with no live key yields zeros on the
    card)."""
    if q.device.type == "cpu":
        family = dict(softcap=softcap, window=window, scale=scale)
        if q.shape[1] == 1:
            return paged_decode_attention_quant(
                q[:, 0], k_pool, k_scale, v_pool, v_scale, block_tables, lengths, **family
            )[:, None]
        return paged_chunk_attention_quant(
            q, k_pool, k_scale, v_pool, v_scale, block_tables, starts, lengths, **family
        )
    _check_quant_inputs(q, k_pool, k_scale, v_pool, v_scale, block_tables, starts, lengths)
    batch, seq, heads, dim = q.shape
    num_blocks, block_size, kv_heads = k_pool.shape[:3]
    lib = _build.load("paged_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.paged_attention_quant(
        q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(), v_pool.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
        lengths.data_ptr(), batch, seq, heads, kv_heads, dim, num_blocks, block_size,
        block_tables.shape[1], KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), stream,
    )
    _build.check(status, "paged_attention_quant")
    ragged_paged_attention_quant.launches += 1
    return out


ragged_paged_attention_quant.launches = 0

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

What bounds it on the H100, and what the design does about it: at
decode (one query token, G score rows a CTA) the one warp that computes
the tile, walking a long row's key tiles one after another, while the
k/v tiles stream through a three-stage ``cp.async`` ring; at
prefill-at-offset (64 score rows a CTA) latency and the uneven key
ranges of the CTAs rather than the arithmetic, so the products run on
the tensor cores (``mma.sync`` bf16, the softmax state and the output
accumulator in registers) and the CTAs of the last q tiles, which see
the most keys, start first. bf16 q takes that body over bf16 or int8
pools; f32 q (the tests) keeps the first version's FP32-FMA body.

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

:func:`ragged_q_paged_attention` and its int8 twin
:func:`ragged_q_paged_attention_quant` replace the token-ragged TPU
kernels ``_ragged_q_kernel`` and ``_ragged_q_kernel_quant`` (B7, B8), the
launch of the mixed prefill+decode step: q is a flat [Q, H, D] tile whose
rows start at ``q_offsets`` (cu_q_lens style), each row carrying its own
live count ``lengths - starts``. They launch the same kernel body through
the entry points ``paged_attention_ragged_q(_quant)``; their plain
versions are ``paged_ragged_q_attention(_quant)``, which un-flatten the
spans and run ``paged_chunk_attention(_quant)``.

Under tensor parallelism a rank launches each on its own heads:
:func:`ragged_paged_attention_sharded` (B3, B6) and
:func:`ragged_q_paged_attention_sharded` (B7, B8), JAX's ``shard_map``
twins, with no collective.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops.attention import (
    paged_chunk_attention,
    paged_chunk_attention_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
    paged_ragged_q_attention,
    paged_ragged_q_attention_quant,
)
from langstream_tpu_torch.parallel.mesh import head_shard

KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 256
# a CTA's tile holds at most this many score rows (query tokens x the
# query heads of one kv head): MAX_ROWS in the .cu, four m16 row tiles
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


def _check_inputs(name, q, pools, block_tables, row_ints, *, batch, quantized) -> None:
    """Raise on what the kernel does not take. ``pools``: (k_pool,
    v_pool), or (k_pool, k_scale, v_pool, v_scale) over int8 pools;
    ``row_ints``: the int32 [batch] operands by name."""
    heads, dim = q.shape[-2:]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    k_pool, v_pool = pools[0], pools[-2]
    labels = ("k_pool", "k_scale", "v_pool", "v_scale") if quantized else ("k_pool", "v_pool")
    tensors = (*zip(labels, pools), ("block_tables", block_tables), *row_ints.items())
    for label, tensor in tensors:
        if tensor.device != q.device:
            raise ValueError(f"{name}: {label} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: q must be one of {list(KERNEL_DTYPES)}, got {q.dtype}")
    if quantized:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"{name}: the pools must be int8, got {k_pool.dtype}/{v_pool.dtype}")
        k_scale, v_scale = pools[1], pools[3]
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"{name}: q and the pools must share one of {list(KERNEL_DTYPES)}, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or k_pool.shape[3] != dim:
        raise ValueError(
            f"{name}: pools must be [N, Bs, KVH, D] matching q {tuple(q.shape)}, got "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
        )
    if quantized and (pools[1].shape != k_pool.shape[:3] or pools[3].shape != k_pool.shape[:3]):
        raise ValueError(
            f"{name}: scales must be [N, Bs, KVH] {tuple(k_pool.shape[:3])}, got "
            f"{tuple(pools[1].shape)}/{tuple(pools[3].shape)}"
        )
    if not fused_shapes_ok(heads, k_pool.shape[2], dim, quantized=quantized):
        raise ValueError(
            f"{name}: {heads} heads over {k_pool.shape[2]} kv heads at head_dim {dim} "
            f"(needs an even grouping of at most {MAX_TILE_ROWS} and a head_dim that is "
            f"a multiple of {16 if quantized else 8} up to {MAX_HEAD_DIM})"
        )
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or block_tables.shape[0] != batch:
        raise ValueError(
            f"{name}: block_tables must be int32 [{batch}, M], got "
            f"{block_tables.dtype} {tuple(block_tables.shape)}"
        )
    for label, tensor in row_ints.items():
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


def _launch(entry, q, pools, block_tables, starts, lengths, softcap, window, scale, verify):
    """One launch of B3 (``entry`` paged_attention) or B6
    (paged_attention_quant) into a new output; returns it. ``verify``
    counts it on the card as a verify block (``ops/launches.py``)."""
    batch, seq, heads, dim = q.shape
    num_blocks, block_size, kv_heads = pools[0].shape[:3]
    out = torch.empty_like(q)
    status = getattr(_build.load("paged_attention"), entry)(
        q.data_ptr(), *(p.data_ptr() for p in pools), out.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), lengths.data_ptr(),
        batch, seq, heads, kv_heads, dim, num_blocks, block_size,
        block_tables.shape[1], KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), int(verify),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, entry)
    return out


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
    verify: bool = False,          # a speculative verify block: counted apart
) -> torch.Tensor:
    """One launch over the block pool for decode, prefill-at-offset, cold
    paged prefill and the speculative verify block (``verify``: the same
    launch, counted on the card in a class of its own). Returns [B, Tq,
    H, D]. Outputs past a row's new-token count (``t >= lengths[b] -
    starts[b]``) are discarded by every caller: the kernel computes
    nothing there, writes zeros and never faults. A row with no live key
    yields zeros on the card."""
    if q.device.type == "cpu":
        family = dict(softcap=softcap, window=window, scale=scale)
        if q.shape[1] == 1:
            return paged_decode_attention(
                q[:, 0], k_pool, v_pool, block_tables, lengths, **family
            )[:, None]
        return paged_chunk_attention(
            q, k_pool, v_pool, block_tables, starts, lengths, **family
        )
    pools = (k_pool, v_pool)
    _check_inputs("ragged_paged_attention", q, pools, block_tables,
                  {"starts": starts, "lengths": lengths}, batch=q.shape[0], quantized=False)
    out = _launch("paged_attention", q, pools, block_tables, starts, lengths, softcap, window, scale,
                  verify)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


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
    verify: bool = False,
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
    pools = (k_pool, k_scale, v_pool, v_scale)
    _check_inputs("ragged_paged_attention_quant", q, pools, block_tables,
                  {"starts": starts, "lengths": lengths}, batch=q.shape[0], quantized=True)
    out = _launch("paged_attention_quant", q, pools, block_tables, starts, lengths,
                  softcap, window, scale, verify)
    ragged_paged_attention_quant.launches += 1
    return out


ragged_paged_attention_quant.launches = 0


# ---------------------------------------------------------------------- #
# The token-ragged form (B7, B8): the mixed prefill+decode step's launch
# ---------------------------------------------------------------------- #
def _check_tiles(name, q, q_offsets, offsets_host, *, batch, max_q_len, block_q) -> None:
    """The spans must tile by ``block_q`` (JAX raises the same "tile"
    error), and each row's span must start ``block_q``-aligned and lie
    inside the flat tile. The offsets are checked on the host as the
    caller built them (``offsets_host``), or else read from ``q_offsets``,
    which makes the host wait for the card. (On the card a span outside
    the tile is skipped by the kernel, never written.)"""
    total_q = q.shape[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be a flat [Q, H, D] tile, got {tuple(q.shape)}")
    if block_q <= 0 or max_q_len <= 0 or max_q_len % block_q or total_q % block_q:
        raise ValueError(
            f"{name}: ragged-q spans must tile by block_q={block_q} "
            f"(max_q_len={max_q_len}, flat q={total_q})"
        )
    if q_offsets.shape != (batch,):
        raise ValueError(f"{name}: q_offsets must be [{batch}], got {tuple(q_offsets.shape)}")
    offsets = torch.as_tensor(
        q_offsets.cpu() if offsets_host is None else offsets_host, dtype=torch.long)
    if offsets.shape != (batch,):
        raise ValueError(f"{name}: q_offsets_host must hold {batch} offsets")
    if bool((offsets % block_q != 0).any()):
        raise ValueError(f"{name}: every q_offsets[b] must be a multiple of the q tile {block_q}")
    if bool(((offsets < 0) | (offsets + max_q_len > total_q)).any()):
        raise ValueError(f"{name}: a row's span of {max_q_len} tokens lies outside q [{total_q}]")


def _ragged_q(wrapper, entry, q, pools, block_tables, starts, lengths, q_offsets, *,
              max_q_len, softcap, window, scale, block_q, q_offsets_host) -> torch.Tensor:
    """B7 or B8 (C entry point ``entry``, counted on ``wrapper``): the
    checks, then the kernel on the card or the plain version on the
    CPU."""
    name = wrapper.__name__
    batch = block_tables.shape[0]
    block_q = min(block_q or 8, max_q_len)
    _check_tiles(name, q, q_offsets, q_offsets_host, batch=batch, max_q_len=max_q_len,
                 block_q=block_q)
    family = dict(softcap=softcap, window=window, scale=scale)
    if q.device.type == "cpu":
        plain = paged_ragged_q_attention_quant if len(pools) == 4 else paged_ragged_q_attention
        return plain(q, *pools, block_tables, starts, lengths, q_offsets,
                     max_q_len=max_q_len, block_q=block_q, **family)
    _check_inputs(name, q, pools, block_tables,
                  {"starts": starts, "lengths": lengths, "q_offsets": q_offsets},
                  batch=batch, quantized=len(pools) == 4)
    total_q, heads, dim = q.shape
    num_blocks, block_size, kv_heads = pools[0].shape[:3]
    # positions no row's span covers stay zero
    out = torch.zeros_like(q)
    status = getattr(_build.load("paged_attention"), entry)(
        q.data_ptr(), *(p.data_ptr() for p in pools), out.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), lengths.data_ptr(), q_offsets.data_ptr(),
        batch, total_q, max_q_len, block_q, heads, kv_heads, dim, num_blocks, block_size,
        block_tables.shape[1], KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, entry)
    wrapper.launches += 1
    return out


def ragged_q_paged_attention(
    q: torch.Tensor,             # [Q, H, D] flattened new-token tile
    k_pool: torch.Tensor,        # [N, Bs, KVH, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    starts: torch.Tensor,        # [B] int32 global position of each row's query 0
    lengths: torch.Tensor,       # [B] int32 TOTAL live context (prefix + new)
    q_offsets: torch.Tensor,     # [B] int32 row offsets into the flat q tile
    *,
    max_q_len: int,              # per-row span capacity in q
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
    block_q: Optional[int] = None,  # q tile (default 8, at most max_q_len)
    q_offsets_host: Optional[Sequence[int]] = None,  # q_offsets' values, known
                                                     # on the host (None: read)
) -> torch.Tensor:
    """Token-ragged paged attention (B7): one launch serves rows with
    0 .. ``max_q_len`` new tokens each, the mixed prefill+decode step's
    shape. Row ``b``'s live queries are ``lengths[b] - starts[b]`` tokens
    at ``q_offsets[b] ..`` of the flat ``q`` tile (decode rows 1, prefill
    windows their width, idle rows 0); spans are ``block_q``-aligned.
    Returns the flat [Q, H, D] outputs: each live row equal to
    :func:`ragged_paged_attention`'s for that row (bitwise on the card at
    window 0), q tiles past a row's live count exactly zero, and
    positions no span covers zero. Padding positions inside a live tile
    are discarded by every caller (zero on the card; the plain version
    computes them). A caller that built ``q_offsets`` on the host passes
    the same values as ``q_offsets_host``, so that the checks need no
    read from the card."""
    return _ragged_q(
        ragged_q_paged_attention, "paged_attention_ragged_q", q, (k_pool, v_pool),
        block_tables, starts, lengths, q_offsets, max_q_len=max_q_len, softcap=softcap,
        window=window, scale=scale, block_q=block_q, q_offsets_host=q_offsets_host,
    )


ragged_q_paged_attention.launches = 0


def ragged_q_paged_attention_quant(
    q: torch.Tensor,             # [Q, H, D]
    k_pool: torch.Tensor,        # [N, Bs, KVH, D] int8
    k_scale: torch.Tensor,       # [N, Bs, KVH] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32
    starts: torch.Tensor,        # [B] int32
    lengths: torch.Tensor,       # [B] int32 TOTAL live context
    q_offsets: torch.Tensor,     # [B] int32
    *,
    max_q_len: int,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    q_offsets_host: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """:func:`ragged_q_paged_attention` over int8 pools (B8): the scales
    fold as in :func:`ragged_paged_attention_quant`, whose rows it equals."""
    return _ragged_q(
        ragged_q_paged_attention_quant, "paged_attention_ragged_q_quant", q,
        (k_pool, k_scale, v_pool, v_scale), block_tables, starts, lengths, q_offsets,
        max_q_len=max_q_len, softcap=softcap, window=window, scale=scale, block_q=block_q,
        q_offsets_host=q_offsets_host,
    )


ragged_q_paged_attention_quant.launches = 0


def ragged_paged_attention_sharded(
    q: torch.Tensor,             # [B, Tq, H, D], every head
    k_pool: torch.Tensor,        # [N, Bs, KVH, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32 (every rank's, whole)
    starts: torch.Tensor,        # [B] int32
    lengths: torch.Tensor,       # [B] int32
    *,
    rank: int,
    size: int,
    k_scale: Optional[torch.Tensor] = None,  # [N, Bs, KVH] f32: int8 pools
    v_scale: Optional[torch.Tensor] = None,
    **kwargs,
) -> torch.Tensor:
    """Ragged paged attention under tensor parallelism, the JAX
    ``ragged_paged_attention_sharded``: tp rank ``rank`` of ``size``
    launches the same kernel (B3, or B6 with scales) on its H/size query
    heads over its KVH/size kv heads of the pool; the block tables,
    starts and lengths are every rank's. Returns [B, Tq, H/size, D]. No
    collective: attention never mixes kv heads."""
    q_l = head_shard(q, 2, rank, size)
    k_l, v_l = (head_shard(t, 2, rank, size) for t in (k_pool, v_pool))
    if k_scale is None:
        return ragged_paged_attention(q_l, k_l, v_l, block_tables, starts, lengths, **kwargs)
    return ragged_paged_attention_quant(
        q_l, k_l, head_shard(k_scale, 2, rank, size), v_l, head_shard(v_scale, 2, rank, size),
        block_tables, starts, lengths, **kwargs)


def ragged_q_paged_attention_sharded(
    q: torch.Tensor,             # [Q, H, D] flattened new-token tile, every head
    k_pool: torch.Tensor,        # [N, Bs, KVH, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] int32 (every rank's, whole)
    starts: torch.Tensor,        # [B] int32
    lengths: torch.Tensor,       # [B] int32
    q_offsets: torch.Tensor,     # [B] int32 (every rank's)
    *,
    rank: int,
    size: int,
    max_q_len: int,
    k_scale: Optional[torch.Tensor] = None,  # [N, Bs, KVH] f32: int8 pools
    v_scale: Optional[torch.Tensor] = None,
    **kwargs,
) -> torch.Tensor:
    """Token-ragged paged attention under tensor parallelism, the JAX
    ``ragged_q_paged_attention_sharded``: tp rank ``rank`` of ``size``
    launches B7 (B8 with scales) on its H/size query heads over its
    KVH/size kv heads, as :func:`ragged_paged_attention_sharded` does for
    B3; the tables, starts, lengths and ``q_offsets`` are every rank's.
    Returns [Q, H/size, D]. No collective."""
    q_l = head_shard(q, 1, rank, size)
    k_l, v_l = (head_shard(t, 2, rank, size) for t in (k_pool, v_pool))
    if k_scale is None:
        return ragged_q_paged_attention(q_l, k_l, v_l, block_tables, starts, lengths, q_offsets,
                                        max_q_len=max_q_len, **kwargs)
    return ragged_q_paged_attention_quant(
        q_l, k_l, head_shard(k_scale, 2, rank, size), v_l, head_shard(v_scale, 2, rank, size),
        block_tables, starts, lengths, q_offsets, max_q_len=max_q_len, **kwargs)

"""Length-aware decode attention (flash-decode): the CUDA kernel and its
wrapper.

Port of ``langstream_tpu/ops/decode_kernel.py``. The TPU kernel
(``_decode_kernel``, body ``_decode_kernel_body``: a (slot, kv block)
grid whose index maps clamp dead blocks so they cost no HBM traffic)
becomes the Hopper kernel in ``csrc/flash_decode.cu``. For a bf16 q it
splits each slot's live key tiles over the CTAs of one thread-block
cluster (a number fixed by the shapes), splits every key tile over the
CTA's warps, runs both products on the tensor cores over a ``cp.async``
ring, and combines the partial softmax states in a fixed order, so the
output is the same bits on every launch. Only tiles from the first
inside the sliding window to the last holding a live row are read. Its
design note is at the top of that file.

:func:`flash_decode_attention` keeps the JAX API's shapes. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs the
plain version, :func:`langstream_tpu_torch.ops.attention.decode_attention`.
There is no allocated-length threshold: on the card every decode step of
every layer goes through the kernel.

:func:`flash_decode_attention_quant` is the int8 twin
(``_decode_kernel_quant``): an int8 cache with one f32 scale per
(position, kv head), the same kernel source instantiated for int8 tiles
(entry point ``flash_decode_quant``); plain version
:func:`~langstream_tpu_torch.ops.attention.decode_attention_quant`.
"""

from __future__ import annotations

from typing import Optional

import torch

from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops.attention import decode_attention, decode_attention_quant
from langstream_tpu_torch.parallel.mesh import head_shard

KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check_inputs(q, k_cache, v_cache, lengths) -> None:
    slots, heads, dim = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device {q.device}")
    for name, tensor in (("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if tensor.device != q.device:
            raise ValueError(f"flash_decode_attention: {name} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"flash_decode_attention: q and the cache must share one of "
            f"{list(KERNEL_DTYPES)}, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}"
        )
    if (
        k_cache.dim() != 4 or k_cache.shape != v_cache.shape
        or k_cache.shape[0] != slots or k_cache.shape[3] != dim
    ):
        raise ValueError(
            f"flash_decode_attention: cache must be [S, T, KVH, D] matching q "
            f"{tuple(q.shape)}, got {tuple(k_cache.shape)}/{tuple(v_cache.shape)}"
        )
    if heads % k_cache.shape[2] != 0:
        raise ValueError(f"flash_decode_attention: {heads} heads over {k_cache.shape[2]} kv heads")
    if dim % 8 != 0 or not 0 < dim <= 256:
        raise ValueError(f"flash_decode_attention: head_dim {dim} must be a multiple of 8 <= 256")
    if lengths.dtype != torch.int32 or lengths.shape != (slots,):
        raise ValueError(
            f"flash_decode_attention: lengths must be int32 [{slots}], got "
            f"{lengths.dtype} {tuple(lengths.shape)}"
        )
    for name, tensor in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if not tensor.is_contiguous():
            raise ValueError(f"flash_decode_attention: {name} must be contiguous")
    for name, tensor in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"flash_decode_attention: {name} must be 16-byte aligned")


def flash_decode_attention(
    q: torch.Tensor,        # [S, H, D] — one new token per slot
    k_cache: torch.Tensor,  # [S, T, KVH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [S] int32 valid rows incl. the new token
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention with cache reads proportional to the live
    context. An empty slot (length 0) yields zeros on the card; live
    slots match :func:`decode_attention`."""
    if q.device.type == "cpu":
        return decode_attention(
            q, k_cache, v_cache, lengths,
            softcap=softcap, window=window, scale=scale,
        )
    _check_inputs(q, k_cache, v_cache, lengths)
    slots, heads, dim = q.shape
    lib = _build.load("flash_decode")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), slots, k_cache.shape[1], heads, k_cache.shape[2],
        dim, KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), stream,
    )
    _build.check(status, "flash_decode")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def _check_quant_inputs(q, k_cache, k_scale, v_cache, v_scale, lengths) -> None:
    name = "flash_decode_attention_quant"
    slots, heads, dim = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    tensors = (
        ("k_cache", k_cache), ("k_scale", k_scale), ("v_cache", v_cache),
        ("v_scale", v_scale), ("lengths", lengths),
    )
    for label, tensor in tensors:
        if tensor.device != q.device:
            raise ValueError(f"{name}: {label} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: q must be one of {list(KERNEL_DTYPES)}, got {q.dtype}")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise TypeError(f"{name}: the cache must be int8, got {k_cache.dtype}/{v_cache.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    if (
        k_cache.dim() != 4 or k_cache.shape != v_cache.shape
        or k_cache.shape[0] != slots or k_cache.shape[3] != dim
    ):
        raise ValueError(
            f"{name}: cache must be [S, T, KVH, D] matching q {tuple(q.shape)}, got "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}"
        )
    if k_scale.shape != k_cache.shape[:3] or v_scale.shape != k_cache.shape[:3]:
        raise ValueError(
            f"{name}: scales must be [S, T, KVH] {tuple(k_cache.shape[:3])}, got "
            f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}"
        )
    if heads % k_cache.shape[2] != 0:
        raise ValueError(f"{name}: {heads} heads over {k_cache.shape[2]} kv heads")
    if dim % 16 != 0 or not 0 < dim <= 256:
        raise ValueError(f"{name}: head_dim {dim} must be a multiple of 16 up to 256")
    if lengths.dtype != torch.int32 or lengths.shape != (slots,):
        raise ValueError(
            f"{name}: lengths must be int32 [{slots}], got {lengths.dtype} {tuple(lengths.shape)}"
        )
    for label, tensor in (("q", q),) + tensors:
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, tensor in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def flash_decode_attention_quant(
    q: torch.Tensor,        # [S, H, D]
    k_cache: torch.Tensor,  # [S, T, KVH, D] int8
    k_scale: torch.Tensor,  # [S, T, KVH] f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,  # [S] int32 valid rows incl. the new token
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over an int8 cache, reading the live context
    only. An empty slot yields zeros on the card; live slots match
    :func:`decode_attention_quant`."""
    if q.device.type == "cpu":
        return decode_attention_quant(
            q, k_cache, k_scale, v_cache, v_scale, lengths,
            softcap=softcap, window=window, scale=scale,
        )
    _check_quant_inputs(q, k_cache, k_scale, v_cache, v_scale, lengths)
    slots, heads, dim = q.shape
    lib = _build.load("flash_decode")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_decode_quant(
        q.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(), v_cache.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), lengths.data_ptr(), slots, k_cache.shape[1],
        heads, k_cache.shape[2], dim, KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), stream,
    )
    _build.check(status, "flash_decode_quant")
    flash_decode_attention_quant.launches += 1
    return out


flash_decode_attention_quant.launches = 0


def flash_decode_attention_sharded(
    q: torch.Tensor,        # [S, H, D], every head
    k_cache: torch.Tensor,  # [S, T, KVH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [S] int32
    *,
    rank: int,
    size: int,
    k_scale: Optional[torch.Tensor] = None,  # [S, T, KVH] f32: an int8 cache
    v_scale: Optional[torch.Tensor] = None,
    **kwargs,
) -> torch.Tensor:
    """Flash decode under tensor parallelism, the JAX
    ``flash_decode_attention_sharded``: tp rank ``rank`` of ``size``
    launches the same kernel (B2, or B5 with scales) on its own H/size
    query heads over its KVH/size kv heads of the cache, and returns them,
    [S, H/size, D]. No collective: attention never mixes heads."""
    q_l = head_shard(q, 1, rank, size)
    k_l, v_l = (head_shard(t, 2, rank, size) for t in (k_cache, v_cache))
    if k_scale is None:
        return flash_decode_attention(q_l, k_l, v_l, lengths, **kwargs)
    return flash_decode_attention_quant(
        q_l, k_l, head_shard(k_scale, 2, rank, size), v_l, head_shard(v_scale, 2, rank, size),
        lengths, **kwargs)

"""Length-aware decode attention (flash-decode): the CUDA kernel and its
wrapper.

Port of ``langstream_tpu/ops/decode_kernel.py``. The TPU kernel
(``_decode_kernel``, body ``_decode_kernel_body``: a (slot, kv block)
grid whose index maps clamp dead blocks so they cost no HBM traffic)
becomes the Hopper kernel in ``csrc/flash_decode.cu``: one CTA per (kv
head, slot) that walks only the live tiles, from the first tile inside the
sliding window to the last tile holding a live row. Its design note is at
the top of that file.

:func:`flash_decode_attention` keeps the JAX API's shapes. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs the
plain version, :func:`langstream_tpu_torch.ops.attention.decode_attention`.
There is no allocated-length threshold: on the card every decode step of
every layer goes through the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops.attention import decode_attention

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

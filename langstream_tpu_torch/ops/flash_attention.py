"""Causal flash attention for prefill: the CUDA kernel and its wrapper.

Port of ``langstream_tpu/ops/flash_attention.py``. The TPU kernel
(``_flash_kernel``, a Pallas call over a (batch, head, q block, k block)
grid carrying the online softmax in VMEM scratch) becomes the Hopper
kernel in ``csrc/flash_prefill.cu``: one CTA per (q tile, head, batch
row) with the k-block loop inside the CTA; for bf16 q, warpgroup
tensor-core products (``wgmma``) fed by TMA through tensor maps that the
C entry point encodes on each call. Its design note is at the top of
that file.

:func:`flash_prefill_attention` keeps the JAX API's ``[B, T, H, D]``
layout at its public face. On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs the plain version,
:func:`langstream_tpu_torch.ops.attention.prefill_attention`. There is no
length threshold: on the card every prefill goes through the kernel.

:func:`flash_prefill_attention_quant` is the int8 twin (``_flash_kernel_quant``):
k/v int8 with one f32 scale per (position, kv head), the same kernel
source instantiated for int8 tiles (entry point ``flash_prefill_quant``).
Its plain version is :func:`~langstream_tpu_torch.ops.attention.
chunk_attention_quant` with every start 0, the formula warm and long
prefills use, so cold and warm int8 paths see the same algebra. Unlike
the TPU body, the kernel keeps the scale-folded p in f32 for p·v.
"""

from __future__ import annotations

from typing import Optional

import torch

from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops.attention import chunk_attention_quant, prefill_attention

KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_HEAD_DIMS = (64, 128, 256)


def _lengths_of(batch, seq, mask, lengths, device):
    if lengths is not None:
        return lengths
    if mask is not None:
        return mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    return torch.full((batch,), seq, dtype=torch.int32, device=device)


def _check_inputs(q, k, v, lengths) -> None:
    batch, seq, heads, dim = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention: unsupported device {q.device}")
    for name, tensor in (("k", k), ("v", v), ("lengths", lengths)):
        if tensor.device != q.device:
            raise ValueError(f"flash_prefill_attention: {name} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_prefill_attention: q/k/v must share one of "
            f"{list(KERNEL_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (batch, seq) or k.shape[3] != dim:
        raise ValueError(
            f"flash_prefill_attention: k/v must be [B, T, KVH, D] matching q "
            f"{tuple(q.shape)}, got {tuple(k.shape)}/{tuple(v.shape)}"
        )
    if heads % k.shape[2] != 0:
        raise ValueError(f"flash_prefill_attention: {heads} heads over {k.shape[2]} kv heads")
    if dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_prefill_attention: head_dim {dim} not in {KERNEL_HEAD_DIMS}")
    if lengths.dtype != torch.int32 or lengths.shape != (batch,):
        raise ValueError(
            f"flash_prefill_attention: lengths must be int32 [{batch}], got "
            f"{lengths.dtype} {tuple(lengths.shape)}"
        )
    for name, tensor in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not tensor.is_contiguous():
            raise ValueError(f"flash_prefill_attention: {name} must be contiguous")
    if q.dtype == torch.bfloat16:  # the tensor-core body reads q, k and v by TMA
        for name, tensor in (("q", q), ("k", k), ("v", v)):
            if tensor.data_ptr() % 16:
                raise ValueError(f"flash_prefill_attention: {name} must be 16-byte aligned")


def flash_prefill_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, KVH, D]
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,     # [B, T] right-padded valid mask
    lengths: Optional[torch.Tensor] = None,  # [B] int32 (alternative to mask)
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal flash attention over right-padded prompts ([B, T, H, D] in
    and out). ``mask`` must be contiguous right-padding: it is collapsed
    to per-row lengths. Rows that no key may attend to (padding rows
    outside every window, or a row of an empty prompt) come out as zeros,
    as from the TPU kernel; valid rows match :func:`prefill_attention`."""
    batch, seq, heads, dim = q.shape
    lengths = _lengths_of(batch, seq, mask, lengths, q.device)
    if q.device.type == "cpu":
        valid = torch.arange(seq, device=q.device)[None, :] < lengths[:, None]
        return prefill_attention(
            q, k, v, mask=valid, softcap=softcap, window=window, scale=scale
        )
    _check_inputs(q, k, v, lengths)
    lib = _build.load("flash_prefill")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), batch, seq, heads, k.shape[2], dim,
        KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), stream,
    )
    _build.check(status, "flash_prefill")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


def _check_quant_inputs(q, k, k_scale, v, v_scale, lengths) -> None:
    name = "flash_prefill_attention_quant"
    batch, seq, heads, dim = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    tensors = (("k", k), ("k_scale", k_scale), ("v", v), ("v_scale", v_scale), ("lengths", lengths))
    for label, tensor in tensors:
        if tensor.device != q.device:
            raise ValueError(f"{name}: {label} on {tensor.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: q must be one of {list(KERNEL_DTYPES)}, got {q.dtype}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{name}: k/v must be int8, got {k.dtype}/{v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (batch, seq) or k.shape[3] != dim:
        raise ValueError(
            f"{name}: k/v must be [B, T, KVH, D] matching q {tuple(q.shape)}, got "
            f"{tuple(k.shape)}/{tuple(v.shape)}"
        )
    if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
        raise ValueError(
            f"{name}: scales must be [B, T, KVH] {tuple(k.shape[:3])}, got "
            f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}"
        )
    if heads % k.shape[2] != 0:
        raise ValueError(f"{name}: {heads} heads over {k.shape[2]} kv heads")
    if dim % 16 != 0 or not 0 < dim <= 256:
        raise ValueError(f"{name}: head_dim {dim} must be a multiple of 16 up to 256")
    if lengths.dtype != torch.int32 or lengths.shape != (batch,):
        raise ValueError(
            f"{name}: lengths must be int32 [{batch}], got {lengths.dtype} {tuple(lengths.shape)}"
        )
    for label, tensor in (("q", q),) + tensors:
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    aligned = (("q", q), ("k", k), ("v", v)) if q.dtype == torch.bfloat16 else (("k", k), ("v", v))
    for label, tensor in aligned:
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def flash_prefill_attention_quant(
    q: torch.Tensor,        # [B, T, H, D]
    k: torch.Tensor,        # [B, T, KVH, D] int8
    k_scale: torch.Tensor,  # [B, T, KVH] f32
    v: torch.Tensor,        # [B, T, KVH, D] int8
    v_scale: torch.Tensor,  # [B, T, KVH] f32
    *,
    mask: Optional[torch.Tensor] = None,     # [B, T] right-padded valid mask
    lengths: Optional[torch.Tensor] = None,  # [B] int32 (alternative to mask)
    softcap: Optional[float] = None,
    window: Optional[int] = None,  # None/0 = full attention
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal flash attention over an int8-quantized prompt window ([B,
    T, H, D] in and out, q's dtype). Valid rows match
    :func:`chunk_attention_quant` with every start 0; rows that no key may
    attend to come out as zeros on the card."""
    batch, seq, heads, dim = q.shape
    lengths = _lengths_of(batch, seq, mask, lengths, q.device)
    if q.device.type == "cpu":
        return chunk_attention_quant(
            q, k, k_scale, v, v_scale, torch.zeros_like(lengths), lengths,
            softcap=softcap, window=window, scale=scale,
        )
    _check_quant_inputs(q, k, k_scale, v, v_scale, lengths)
    lib = _build.load("flash_prefill")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_prefill_quant(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), lengths.data_ptr(), batch, seq, heads, k.shape[2], dim,
        KERNEL_DTYPES[q.dtype],
        float(dim ** -0.5 if scale is None else scale),
        float(softcap or 0.0), int(window or 0), stream,
    )
    _build.check(status, "flash_prefill_quant")
    flash_prefill_attention_quant.launches += 1
    return out


flash_prefill_attention_quant.launches = 0

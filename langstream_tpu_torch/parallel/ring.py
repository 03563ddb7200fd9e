"""Ring attention: causal attention with the sequence split over a mesh
axis (context parallelism for long prompts).

Port of ``langstream_tpu/parallel/ring.py``. Each rank of the ``sp``
group holds one contiguous chunk of the sequence (q, k, v all [B, T/sp,
H, D]). The kv chunks, with their padding mask, rotate around the ring
(``collectives.ppermute``, whose backward sends the gradients back the
other way) while every rank accumulates its own queries' attention with
the online-softmax recurrence: the flash kernel's arithmetic, with the
blocking axis laid across ranks. Causality follows the global positions:
after ``s`` rotations a rank holds the chunk of rank ``rank - s``.

The JAX package's ``_chunk_attend`` is two einsums, and so is the port's:
there is no kernel on this path. :func:`ring_attention` takes the local
chunks; :func:`ring_attention_sharded` takes the whole tensors on every
rank, cuts them, and gathers the output, differentiably.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from langstream_tpu_torch.parallel import collectives

NEG_INF = -1e30


def _chunk_attend(
    q: torch.Tensor,        # [B, Tq, KVH, G, D] grouped queries
    k: torch.Tensor,        # [B, Tk, KVH, D]
    v: torch.Tensor,        # [B, Tk, KVH, D]
    allowed: torch.Tensor,  # [B, Tq, Tk] mask
    m: torch.Tensor,        # [B, KVH, G, Tq, 1]
    l: torch.Tensor,        # [B, KVH, G, Tq, 1]
    acc: torch.Tensor,      # [B, Tq, KVH, G, D] f32
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax update of the local queries against one kv
    chunk, f32 scores."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale  # [B, KVH, G, Tq, Tk]
    mask = allowed[:, None, None]  # [B, 1, 1, Tq, Tk]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new) * mask.float()
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v).float()
    acc_new = acc * alpha.movedim(3, 1) + pv  # alpha [B, KVH, G, Tq, 1] → [B, Tq, KVH, G, 1]
    return m_new, l_new, acc_new


def ring_attention(
    q: torch.Tensor,  # local [B, Tl, H, D]
    k: torch.Tensor,  # local [B, Tl, KVH, D]
    v: torch.Tensor,
    group,
    *,
    mask: Optional[torch.Tensor] = None,  # local [B, Tl] valid-token mask
    causal: bool = True,
) -> torch.Tensor:
    """Attention of the local queries over the whole sequence split over
    ``group`` (the sp axis's ``parallel.mesh.AxisGroup``): causal by
    global position unless ``causal`` is False; ``mask`` marks the local
    chunk's valid tokens and rotates with its keys."""
    batch, t_local, heads, dim = q.shape
    kv_heads = k.shape[2]
    groups = heads // kv_heads
    scale = dim ** -0.5
    size, rank = group.size, group.rank
    qg = q.reshape(batch, t_local, kv_heads, groups, dim)
    if mask is None:
        mask = torch.ones((batch, t_local), dtype=torch.bool, device=q.device)
    positions = torch.arange(t_local, device=q.device)
    q_pos = rank * t_local + positions

    m = torch.full((batch, kv_heads, groups, t_local, 1), NEG_INF, device=q.device)
    l = torch.zeros((batch, kv_heads, groups, t_local, 1), device=q.device)
    acc = torch.zeros((batch, t_local, kv_heads, groups, dim), device=q.device)
    kv = (k, v, mask.bool())
    for step in range(size):
        # after `step` rotations this rank holds the chunk of rank - step
        src = (rank - step) % size
        k_cur, v_cur, mask_cur = kv
        allowed = mask_cur[:, None, :]  # [B, 1, Tl] key validity
        if causal:
            k_pos = src * t_local + positions
            allowed = allowed & (k_pos[None, :] <= q_pos[:, None])[None]
        else:
            allowed = allowed.expand(batch, t_local, t_local)
        m, l, acc = _chunk_attend(qg, k_cur, v_cur, allowed, m, l, acc, scale)
        if step != size - 1:
            kv = collectives.ppermute(kv, group)
    l_acc = l.movedim(3, 1)  # [B, Tl, KVH, G, 1]
    out = acc / torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return out.reshape(batch, t_local, heads, dim).to(q.dtype)


def ring_attention_sharded(
    q: torch.Tensor,  # whole [B, T, H, D], the same on every rank
    k: torch.Tensor,  # whole [B, T, KVH, D]
    v: torch.Tensor,
    group,
    *,
    mask: Optional[torch.Tensor] = None,  # whole [B, T]
    causal: bool = True,
) -> torch.Tensor:
    """Split q/k/v's sequence over ``group``, run the ring, and gather
    the output whole on every rank. Differentiable: each rank's input
    gradient is the whole one (the chunks' gradients are gathered), as
    the loss every rank computes from the gathered output is the same."""
    size = group.size
    if q.shape[1] % size:
        raise ValueError(f"sequence {q.shape[1]} not divisible by sp={size}")
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    local = [collectives.split(t, group, 1) for t in (q, k, v)]
    out = ring_attention(*local, group, mask=collectives.own_part(group, mask, 1), causal=causal)
    return collectives.gather(out, group, 1, reduce=False)

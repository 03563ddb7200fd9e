"""Ulysses sequence parallelism: all-to-all head-sharded attention.

Port of ``langstream_tpu/parallel/ulysses.py``, the complement of the
ring (``parallel/ring.py``) for long contexts: instead of rotating kv
chunks around the ``sp`` ring, two all-to-alls (``collectives.all_to_all``,
whose backward is the inverse all-to-all) re-shard the activations from
sequence-sharded ([B, T/sp, H, D]) to head-sharded ([B, T, H/sp, D]),
each rank runs the plain full-sequence ``prefill_attention`` on its
heads, and a third all-to-all swaps back.
"""

from __future__ import annotations

from typing import Optional

import torch

from langstream_tpu_torch.ops.attention import prefill_attention
from langstream_tpu_torch.parallel import collectives


def ulysses_attention(
    q: torch.Tensor,  # [B, T/sp, NH, D] local sequence shard
    k: torch.Tensor,  # [B, T/sp, NKV, D]
    v: torch.Tensor,  # [B, T/sp, NKV, D]
    group,
    mask: Optional[torch.Tensor] = None,  # [B, T] the WHOLE sequence's valid mask
) -> torch.Tensor:
    """Causal attention with the sequence split over ``group`` (the sp
    axis's ``parallel.mesh.AxisGroup``); the head counts must divide by
    its size. Returns the local sequence shard of the output."""
    sp = group.size
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(f"ulysses needs heads divisible by sp={sp}: "
                         f"q heads {q.shape[2]}, kv heads {k.shape[2]}")
    # sequence-sharded → head-sharded: split the heads, gather the sequence
    qg, kg, vg = (collectives.all_to_all(t, group, 2, 1) for t in (q, k, v))
    out = prefill_attention(qg, kg, vg, mask=mask)  # [B, T, NH/sp, D]
    # head-sharded → sequence-sharded: split the sequence, gather the heads
    return collectives.all_to_all(out, group, 1, 2)


def ulysses_attention_sharded(
    q: torch.Tensor,  # [B, T, NH, D] whole, the same on every rank
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Split the sequence over ``group``, run :func:`ulysses_attention`
    and gather the output whole on every rank, differentiably (as
    ``ring.ring_attention_sharded``)."""
    if q.shape[2] % group.size or k.shape[2] % group.size:
        raise ValueError(f"ulysses needs heads divisible by sp={group.size}: "
                         f"q heads {q.shape[2]}, kv heads {k.shape[2]}")
    if mask is None:
        mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    local = [collectives.split(t, group, 1) for t in (q, k, v)]
    return collectives.gather(ulysses_attention(*local, group, mask), group, 1, reduce=False)

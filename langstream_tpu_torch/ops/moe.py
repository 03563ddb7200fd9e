"""Mixture-of-experts MLP with top-k routing (the Mixtral family).

Port of ``langstream_tpu/ops/moe.py``, both of its regimes:

- **training** (``capacity_factor`` set): tokens are routed inside fixed
  groups of ``group_size`` (the flattened ``[B, T]`` rows in row-major
  order, so a group may span two sequences; the last group padded) into
  per-expert slots of a fixed capacity through dispatch/combine einsums;
  a token past its expert's capacity is dropped (a zero MLP delta), first
  choices win capacity before any second choice, and the Switch aux loss
  counts every top-k selection, divided by k.
- **exact / serving** (``capacity_factor=None``): every expert runs on
  every token and the outputs combine with the renormalized top-k gates
  (zero for the experts not chosen). No token is dropped and each token is
  routed alone, so the rows of a call may be split into slices. Its aux
  loss counts first choices only.

A ``valid`` mask keeps padding tokens out of capacity and the aux loss.

The module is matrix products and the router's top-k: the JAX package
runs it as XLA einsums and ``lax.top_k``, with no Pallas kernel, and so
does the port (``torch.einsum`` and batched matmuls). Two details carry
the JAX numbers across:

- the router's product runs in f32 with both operands upcast (the port
  never turns TF32 on), and the top-k ranks ties lower expert first, as
  ``lax.top_k`` does (:func:`~langstream_tpu_torch.providers.torch_local.sampling.lax_top_k`;
  ``torch.topk`` promises no order among ties, and equal router logits
  make equal probabilities);
- the combine rounds the gates to the activations' dtype before the sum
  over experts.

One-hot tensors are comparisons against an ``arange``, never
``F.one_hot``, which checks its input's range on the host and so cannot
run inside a captured CUDA graph.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from langstream_tpu_torch.parallel import collectives
from langstream_tpu_torch.providers.torch_local.sampling import lax_top_k


def moe_capacity(
    group_tokens: int,
    num_experts: int,
    num_selected: int,
    capacity_factor: Optional[float],
) -> int:
    """Per-expert capacity within one routing group:
    ``ceil(factor * S * k / E)`` clamped to the all-fits bound ``S * k``
    (``None`` factor → that bound)."""
    dropless = group_tokens * num_selected
    if capacity_factor is None:
        return dropless
    return max(1, min(dropless, int(math.ceil(
        capacity_factor * group_tokens * num_selected / num_experts))))


def _one_hot(index: torch.Tensor, classes: int) -> torch.Tensor:
    """``jax.nn.one_hot`` in f32: an index outside ``[0, classes)`` gives
    a row of zeros."""
    return (index[..., None] == torch.arange(classes, device=index.device)).float()


def _top_gates(logits: torch.Tensor, num_selected: int):
    """(probs, renormalized top-k gates, their expert ids, the one-hot of
    those ids [..., k, E]) of f32 router logits [..., E]."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = lax_top_k(probs, num_selected)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx, _one_hot(gate_idx, logits.shape[-1])


def moe_routing(
    logits: torch.Tensor,                  # [..., S, E] f32 router logits, one group a row
    num_selected: int,
    capacity: int,
    valid: Optional[torch.Tensor] = None,  # [..., S] bool; False = padding
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity inside each group (the JAX
    ``moe_routing``, over any leading group axes, as JAX's ``vmap`` runs
    it).

    Returns:
      dispatch  [..., S, E, C] f32 — 0/1 routing of tokens into expert rows
      combine   [..., S, E, C] f32 — dispatch weighted by the normalized gates
      aux_loss  [...] f32          — Switch-style load-balancing loss of
                                     each group (over valid tokens only)
    """
    onehot, slots, gate_vals, aux_loss = _route(logits, num_selected, capacity, valid)
    dispatch = torch.einsum("...ske,...skc->...sec", onehot, slots)
    combine = torch.einsum("...sk,...ske,...skc->...sec", gate_vals, onehot, slots)
    return dispatch, combine, aux_loss


def _route(logits, num_selected, capacity, valid):
    """:func:`moe_routing`'s pieces → (the one-hot of each choice's
    expert [..., S, k, E], of its slot in that expert [..., S, k, C]
    (zero where it did not fit), the renormalized gates [..., S, k], the
    aux loss [...]); dispatch and combine are their products."""
    num_tokens, num_experts = logits.shape[-2:]
    lead = logits.shape[:-2]
    probs, gate_vals, _, onehot = _top_gates(logits, num_selected)  # onehot [..., S, k, E]
    if valid is not None:
        onehot = onehot * valid[..., None, None].float()
    # position of each (token, choice) within its expert: choice-major
    # priority (all first choices before any second choice)
    flat = onehot.transpose(-3, -2).reshape(*lead, num_selected * num_tokens, num_experts)
    pos_flat = torch.cumsum(flat, dim=-2) - flat
    pos = pos_flat.reshape(*lead, num_selected, num_tokens, num_experts).transpose(-3, -2)
    pos_in_expert = (pos * onehot).sum(-1).to(torch.int32)  # [..., S, k]
    # masked-out choices (padding tokens) have all-zero onehot rows
    fits = (pos_in_expert < capacity) & (onehot.sum(-1) > 0)
    pos_onehot = _one_hot(pos_in_expert, capacity) * fits[..., None].float()

    # E * sum_e (fraction of all top-k selections routed to e) * (mean
    # prob of e), means over valid tokens
    if valid is None:
        denom = float(num_tokens)
        probs_masked = probs
    else:
        denom = torch.clamp_min(valid.float().sum(-1), 1.0)[..., None]
        probs_masked = probs * valid[..., None].float()
    frac_routed = onehot.sum(dim=(-3, -2)) / (num_selected * denom)
    mean_prob = probs_masked.sum(dim=-2) / denom
    aux_loss = num_experts * torch.sum(frac_routed * mean_prob, dim=-1)
    return onehot, pos_onehot, gate_vals, aux_loss


def moe_mlp(
    x: torch.Tensor,         # [..., H]
    router_w: torch.Tensor,  # [H, E]
    w_gate: torch.Tensor,    # [E_local, H, F]
    w_up: torch.Tensor,      # [E_local, H, F]
    w_down: torch.Tensor,    # [E_local, F, H]
    *,
    num_selected: int = 2,
    capacity_factor: Optional[float] = 2.0,
    group_size: int = 64,
    valid: Optional[torch.Tensor] = None,  # [...] bool, x's leading shape
    share_group: Any = None,
    first_expert: int = 0,
    batch_group: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU expert MLP → (output with x's shape, load-balancing aux
    loss). ``capacity_factor=None`` is the exact serving regime
    (:func:`_moe_mlp_dense`); otherwise tokens route in groups of
    ``group_size`` against per-expert capacity.

    On a training mesh (``parallel.mesh``):

    - the expert weights may hold experts ``first_expert ..`` only (ep)
      and a slice of each expert's intermediate columns (tp): the rank
      computes their share of every token's output, and the shares are
      summed over ``share_group`` (``parallel.collectives``'
      ``reduce_sum``). The tokens and the gates enter the share through
      ``enter``, whose backward sums the ranks' partial gradients; the
      router and the aux loss, computed whole on every rank, need none.
    - ``batch_group``: x holds this rank's rows of a global batch split
      over the group. JAX routes within groups of ``group_size`` of the
      *global* tokens, so a group may span two ranks: the router logits
      are gathered over the batch (their backward reduce-scatters, since
      each rank's loss is its own share), every rank routes every group
      and counts the aux loss over all of them, and computes the groups
      that hold its own rows, its rows alone.
    """
    orig_shape = x.shape
    hidden = x.shape[-1]
    x2 = x.reshape(-1, hidden)
    num_tokens = x2.shape[0]
    num_experts = router_w.shape[-1]
    num_selected = min(num_selected, num_experts)

    if capacity_factor is None:
        if share_group is not None or batch_group is not None:
            raise ValueError("the exact MoE regime runs on one card's experts: a training "
                             "mesh runs the capacity regime")
        valid2 = None if valid is None else valid.reshape(-1)
        y, aux = _moe_mlp_dense(x2, router_w, w_gate, w_up, w_down,
                                num_selected=num_selected, valid=valid2)
        return y.reshape(orig_shape), aux

    valid2 = (torch.ones((num_tokens,), dtype=torch.bool, device=x.device)
              if valid is None else valid.reshape(-1).bool())
    logits = x2.float() @ router_w.float()
    offset = 0
    if batch_group is not None and batch_group.size > 1:
        logits = collectives.gather(logits, batch_group, 0, reduce=True)
        valid2 = collectives.all_gather_cat(batch_group, valid2, 0)
        offset = batch_group.rank * num_tokens
    total = logits.shape[0]
    group = min(group_size, total)
    pad = (-total) % group
    if pad:
        logits = F.pad(logits, (0, 0, 0, pad))
        valid2 = torch.cat([valid2, valid2.new_zeros((pad,))])
    num_groups = logits.shape[0] // group
    capacity = moe_capacity(group, num_experts, num_selected, capacity_factor)
    onehot, slots, gate_vals, aux = _route(logits.reshape(num_groups, group, num_experts),
                                           num_selected, capacity,
                                           valid2.reshape(num_groups, group))
    aux_loss = aux.mean()

    # the groups that hold this rank's rows, and those rows within them
    first, last = offset // group, -(-(offset + num_tokens) // group)
    start = offset - first * group
    rows = (last - first) * group
    onehot, slots, gate_vals = (t[first:last] for t in (onehot, slots, gate_vals))
    if share_group is not None:
        x2 = collectives.enter(x2, share_group)
        gate_vals = collectives.enter(gate_vals, share_group)
    onehot = onehot[..., first_expert:first_expert + w_gate.shape[0]]
    dispatch = torch.einsum("gske,gskc->gsec", onehot, slots)
    combine = torch.einsum("gsk,gske,gskc->gsec", gate_vals, onehot, slots)
    xg = F.pad(x2, (0, 0, start, rows - start - num_tokens)).reshape(last - first, group, hidden)

    dtype = x2.dtype
    expert_in = torch.einsum("gsec,gsh->egch", dispatch.to(dtype), xg)
    gate = torch.einsum("egch,ehf->egcf", expert_in, w_gate)
    up = torch.einsum("egch,ehf->egcf", expert_in, w_up)
    expert_out = torch.einsum("egcf,efh->egch", F.silu(gate) * up, w_down)
    y = torch.einsum("gsec,egch->gsh", combine.to(dtype), expert_out)
    y = y.reshape(-1, hidden)[start:start + num_tokens]
    if share_group is not None:
        y = collectives.reduce_sum(y, share_group)
    return y.reshape(orig_shape), aux_loss


def _moe_mlp_dense(
    x2: torch.Tensor,        # [T, H]
    router_w: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    num_selected: int,
    valid: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MoE: every expert runs on every token (``[E, T, F]``
    intermediates, batched matmuls over the expert axis); the outputs
    combine with the renormalized top-k gates, rounded to x's dtype. No
    token is dropped and no dispatch tensor exists."""
    num_experts = router_w.shape[-1]
    logits = x2.float() @ router_w.float()
    probs, gate_vals, _, onehot = _top_gates(logits, num_selected)
    gates = (gate_vals[..., None] * onehot).sum(dim=1)  # [T, E]

    dtype = x2.dtype
    gate_proj = torch.matmul(x2, w_gate)  # [E, T, F]
    up_proj = torch.matmul(x2, w_up)
    out = torch.matmul(F.silu(gate_proj) * up_proj, w_down)  # [E, T, H]
    y = torch.einsum("te,eth->th", gates.to(dtype), out)

    if valid is None:
        denom = float(x2.shape[0])
        probs_masked = probs
        first_choice = onehot[:, 0]
    else:
        vf = valid.float()
        denom = torch.clamp_min(vf.sum(), 1.0)
        probs_masked = probs * vf[:, None]
        first_choice = onehot[:, 0] * vf[:, None]
    aux_loss = num_experts * torch.sum(
        (first_choice.sum(0) / denom) * (probs_masked.sum(0) / denom))
    return y, aux_loss

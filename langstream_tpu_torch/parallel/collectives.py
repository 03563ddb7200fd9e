"""The collectives of training on the mesh, as autograd functions.

The JAX package shards by SPMD and XLA inserts each collective and its
transpose. The port runs one process per rank, so the collectives the
sharded step needs are written out here, each with the backward its
forward implies. Every function takes a group with ``rank``, ``size``,
``process_group`` and ``backend`` (``parallel.mesh.AxisGroup``); a group
of size 1 passes its tensors through. On gloo each collective is staged
through the host (a fresh contiguous copy, then back to the tensor's
device); on NCCL it runs on the card. Sums run in f32 whatever the dtype,
each partial rounded once, and every rank ends with the same values.

- :func:`enter` and :func:`reduce_sum`, Megatron's pair for tp and ep:
  the identity forward with an all-reduce backward where a replicated
  activation enters a sharded region, and the all-reduce of the ranks'
  partial sums with an identity backward where it leaves.
- :func:`gather`, an all-gather along a dimension whose backward is the
  slice of the rank's own part (``reduce=False``: every rank computed the
  same loss from the gathered tensor, as tp's logits are) or a
  reduce-scatter (``reduce=True``: each rank's loss is its own share, as
  fsdp's weights and the batch's router logits are).
- :func:`split`, the dual of the first: a replicated tensor's own part
  forward, the parts all-gathered backward.
- :func:`ppermute`, JAX's ``ppermute`` over a ring: each rank sends to
  ``rank + shift`` and receives from ``rank - shift``
  (``batch_isend_irecv``); the backward sends the gradient back the other
  way.
- :func:`all_to_all`, JAX's tiled ``all_to_all``: ``split_dim`` cut into
  ``size`` parts, part j to rank j, the parts received concatenated along
  ``concat_dim`` in rank order; the backward is the inverse all-to-all.
- :func:`send` and :func:`recv`, plain point-to-point for the pipeline's
  schedule, which orders its backward itself.
- :func:`broadcast`, one rank's tensor to every rank: a KV handoff
  import's rows, which rank 0 alone holds, before each rank keeps its kv
  heads (:func:`own_part`).

Each call adds the bytes it moves (what the rank sends) to
:data:`BYTES_MOVED` under its kind, which the chip smoke reads per step.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, List, Optional, Sequence, Tuple

import torch

# bytes each kind of collective sent from this rank since the last reset
BYTES_MOVED: Counter = Counter()


def reset_bytes() -> None:
    BYTES_MOVED.clear()


def _dist():
    import torch.distributed as dist

    return dist


def _staged(group, tensor: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A fresh contiguous copy the collective may overwrite: on the host
    for gloo, on the tensor's own device for NCCL."""
    device = tensor.device if group.backend == "nccl" else torch.device("cpu")
    return tensor.detach().to(device=device, dtype=dtype or tensor.dtype, copy=True).contiguous()


def _count(kind: str, tensor: torch.Tensor) -> None:
    BYTES_MOVED[kind] += tensor.numel() * tensor.element_size()


# ---------------------------------------------------------------------- #
# the plain collectives (no autograd)
# ---------------------------------------------------------------------- #
def all_reduce_sum(group, tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the group, in f32, back in its dtype
    and device."""
    if group.size == 1:
        return tensor
    staged = _staged(group, tensor, torch.float32)
    _count("all_reduce", staged)
    _dist().all_reduce(staged, group=group.process_group)
    return staged.to(device=tensor.device, dtype=tensor.dtype)


def all_gather_cat(group, tensor: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order."""
    if group.size == 1:
        return tensor
    staged = _staged(group, tensor)
    parts = [torch.empty_like(staged) for _ in range(group.size)]
    _count("all_gather", staged)
    _dist().all_gather(parts, staged, group=group.process_group)
    return torch.cat(parts, dim=dim).to(tensor.device)


def reduce_scatter_sum(group, tensor: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the group of ``tensor``, cut into ``size`` parts along
    ``dim``: this rank's part, in f32, back in the tensor's dtype."""
    if group.size == 1:
        return tensor
    moved = tensor.movedim(dim, 0)
    staged = _staged(group, moved, torch.float32)
    out = torch.empty((staged.shape[0] // group.size, *staged.shape[1:]), dtype=torch.float32,
                      device=staged.device)
    _count("reduce_scatter", staged)
    _dist().reduce_scatter_tensor(out, staged, group=group.process_group)
    return out.to(device=tensor.device, dtype=tensor.dtype).movedim(0, dim)


def broadcast(group, tensor: Optional[torch.Tensor], shape: Sequence[int], dtype: torch.dtype,
              device: Any, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, on ``device`` (the other
    ranks pass None, and every rank the ``shape`` and ``dtype`` that
    ``src`` sends)."""
    if group.size == 1:
        return tensor.to(device)
    dist = _dist()
    if group.rank == src:
        staged = _staged(group, tensor)
        _count("broadcast", staged)
    else:
        on = device if group.backend == "nccl" else "cpu"
        staged = torch.empty(tuple(shape), dtype=dtype, device=on)
    root = dist.get_global_rank(group.process_group, src) if group.process_group is not None else src
    dist.broadcast(staged, root, group=group.process_group)
    return staged.to(device)


def own_part(group, tensor: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/size of ``tensor`` along ``dim``."""
    if group.size == 1:
        return tensor
    width = tensor.shape[dim]
    if width % group.size:
        raise ValueError(f"a group of {group.size} ranks must divide dimension {dim} of size {width}")
    part = width // group.size
    return tensor.narrow(dim, group.rank * part, part)


def _exchange(group, tensors: Sequence[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """Send each tensor to ``rank + shift`` and receive as many of the
    same shapes from ``rank - shift``, in one ``batch_isend_irecv``."""
    dist = _dist()
    world = dist.get_global_rank if group.process_group is not None else (lambda _, rank: rank)
    dst = world(group.process_group, (group.rank + shift) % group.size)
    src = world(group.process_group, (group.rank - shift) % group.size)
    staged = [_staged(group, tensor) for tensor in tensors]
    received = [torch.empty_like(tensor) for tensor in staged]
    ops = []
    for out, into in zip(staged, received):
        _count("ppermute", out)
        ops.append(dist.P2POp(dist.isend, out, dst, group=group.process_group))
        ops.append(dist.P2POp(dist.irecv, into, src, group=group.process_group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [into.to(tensor.device) for into, tensor in zip(received, tensors)]


def send(group, tensor: torch.Tensor, to: int) -> None:
    """Send ``tensor`` to the group's rank ``to``."""
    dist = _dist()
    staged = _staged(group, tensor)
    _count("send", staged)
    dst = dist.get_global_rank(group.process_group, to) if group.process_group is not None else to
    dist.send(staged, dst, group=group.process_group)


def recv(group, like: torch.Tensor, src: int) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and dtype from the group's
    rank ``src``, onto ``like``'s device."""
    dist = _dist()
    device = like.device if group.backend == "nccl" else torch.device("cpu")
    into = torch.empty(like.shape, dtype=like.dtype, device=device)
    source = dist.get_global_rank(group.process_group, src) if group.process_group is not None else src
    dist.recv(into, source, group=group.process_group)
    return into.to(like.device)


def _all_to_all(group, tensor: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    parts = tensor.chunk(group.size, dim=split_dim)
    if len(parts) != group.size or tensor.shape[split_dim] % group.size:
        raise ValueError(f"a group of {group.size} ranks must divide dimension {split_dim} of "
                         f"size {tensor.shape[split_dim]}")
    staged = _staged(group, torch.stack(parts))
    out = torch.empty_like(staged)
    _count("all_to_all", staged)
    _dist().all_to_all_single(out, staged, group=group.process_group)
    return torch.cat(out.to(tensor.device).unbind(0), dim=concat_dim)


# ---------------------------------------------------------------------- #
# the autograd functions
# ---------------------------------------------------------------------- #
class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(ctx.group, grad), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(group, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return all_gather_cat(group, x, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.reduce:
            return reduce_scatter_sum(ctx.group, grad, ctx.dim), None, None, None
        return own_part(ctx.group, grad, ctx.dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_part(group, x, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(ctx.group, grad.contiguous(), ctx.dim), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        ctx.differentiable = [t.is_floating_point() for t in tensors]
        out = _exchange(group, tensors, shift)
        for tensor, differentiable in zip(out, ctx.differentiable):
            if not differentiable:
                ctx.mark_non_differentiable(tensor)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        keep = [i for i, differentiable in enumerate(ctx.differentiable) if differentiable]
        back = _exchange(ctx.group, [grads[i] for i in keep], -ctx.shift) if keep else []
        out: List[Any] = [None] * len(grads)
        for i, grad in zip(keep, back):
            out[i] = grad
        return (None, None, *out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(group, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(ctx.group, grad, ctx.concat_dim, ctx.split_dim), None, None, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a sharded region: the identity,
    whose backward sums the ranks' partial gradients."""
    return x if group is None or group.size == 1 else _Enter.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial sums added (f32, back in x's dtype); the
    backward passes the gradient through."""
    return x if group is None or group.size == 1 else _ReduceSum.apply(x, group)


def gather(x: torch.Tensor, group, dim: int, reduce: bool) -> torch.Tensor:
    """The ranks' parts concatenated along ``dim``; the backward takes
    this rank's part of the gradient, summed over the ranks first where
    ``reduce``."""
    return x if group is None or group.size == 1 else _Gather.apply(x, group, dim, reduce)


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's part of a tensor every rank holds whole; the backward
    gathers the parts' gradients."""
    return x if group is None or group.size == 1 else _Split.apply(x, group, dim)


def ppermute(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> Tuple[torch.Tensor, ...]:
    """Each tensor sent to ``rank + shift`` and received from ``rank -
    shift`` around the group's ring; integer and bool tensors ride along
    without a gradient."""
    if group.size == 1:
        return tuple(tensors)
    return _Ppermute.apply(group, shift, *tensors)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` (see the module's docstring)."""
    return x if group.size == 1 else _AllToAll.apply(x, group, split_dim, concat_dim)

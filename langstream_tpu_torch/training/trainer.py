"""Next-token training on the Llama model definition, on one card or a
mesh of ranks.

Port of ``langstream_tpu/training/trainer.py``: the JAX train step, one
jitted ``value_and_grad`` and optax update over a ``dp × fsdp × tp``
mesh (GPipe over ``pp``), becomes a forward and backward in autograd and
an optimizer step that updates the parameters in place.

- The loss is :func:`loss_fn`: the causal cross-entropy over the
  differentiable ``model.forward``, whose attention is the plain
  ``prefill_attention``, the formulation JAX differentiates; a MoE model
  (Mixtral) adds ``moe_aux_weight`` times the router's load-balancing
  loss, its MLP in the capacity regime, as JAX's trains.
- The optimizer is JAX's chain, ``optax.clip_by_global_norm(grad_clip)``
  then ``optax.adamw(lr, b1, b2, weight_decay)`` with eps 1e-8 and no
  mask (the decay reaches every leaf, norms included). The clip is
  optax's rule, written out (:func:`clip_by_global_norm_`):
  ``clip_grad_norm_`` divides by ``norm + 1e-6`` and scales below the
  max too. ``torch.optim.AdamW`` computes optax's update: its decay
  multiplies by ``1 - lr·wd`` before the Adam step where optax adds
  ``wd·p`` to the update, both from the old parameter. ``mu`` and ``nu``
  keep the parameters' dtype, as optax's do.
- ``remat`` recomputes each layer in the backward
  (``torch.utils.checkpoint``); JAX wraps the whole loss in
  ``jax.checkpoint(..., nothing_saveable)``. The gradient is the same,
  the peak memory is not.

On a mesh (``mesh_config`` of size above 1) each rank is one process of
a ``torch.distributed`` world of ``mesh.size`` ranks (``parallel.launch``),
and the trainer takes every mesh JAX's takes (``validate_mesh(...,
allow_pp=True)``), refusing the others with its messages:

- each leaf is this rank's slice by its logical axes (``shard_params``):
  fsdp on ``embed``, tp on ``heads``, ``mlp`` and ``vocab``, ep on
  ``expert``, pp on ``layers``;
- the global batch's rows split over ``(dp, fsdp)`` in JAX's order, and
  each rank's loss is its share of the global mean (``loss_fn`` with the
  batch group); ``sp`` replicates, as JAX's batch rule leaves it;
- fsdp is ZeRO-3: a leaf is all-gathered just before its use (a layer's
  leaves in that layer, again in its remat) and its gradient
  reduce-scattered; tp and ep run Megatron's pair
  (``parallel.collectives``); ``pp > 1`` runs ``parallel.pipeline``'s
  GPipe schedule with ``num_microbatches`` (default ``2·pp``, JAX's);
- after the backward each gradient is summed over the data axes it is
  replicated on (and over pp for the embedding, final norm and head),
  the clip takes the global norm with each element counted once, and
  AdamW steps on the shards;
- ``save_checkpoint`` gathers every full leaf, ``mu`` and ``nu`` too, to
  rank 0, which writes the step directory one card would (the others
  wait), and ``restore_checkpoint`` gives each rank its slice: a
  checkpoint is the same whatever mesh wrote it or reads it.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.ops.losses import causal_ce_loss
from langstream_tpu_torch.parallel import collectives
from langstream_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    MeshConfig,
    build_mesh,
    leaf_splits,
    mesh_coords,
    shard_leaf,
    validate_mesh,
)
from langstream_tpu_torch.providers.torch_local import model as model_lib

ADAM_EPS = 1e-8  # optax.adamw's default


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True
    # MoE load-balancing loss weight (ignored for dense models)
    moe_aux_weight: float = 0.01
    # GPipe microbatches per step on pp>1 meshes (0: two per stage)
    num_microbatches: int = 0


def loss_fn(config, params, tokens, mask, freqs, remat: bool = False,
            moe_aux_weight: float = 0.01, group=None, layers=None) -> torch.Tensor:
    """Causal next-token cross-entropy, mean over valid positions, plus
    ``moe_aux_weight`` times the router's load-balancing loss for a MoE
    model (a dense model's aux loss is 0). With ``group`` (the batch
    axes' group, this rank holding its rows): this rank's share of the
    global loss, its targets' NLL over every rank's count, and the aux
    loss (the same on every rank: the routing groups are the global
    batch's) over the group's size, so that the shares add up to the
    global loss. ``layers``: ``model.forward``'s."""
    logits, aux = model_lib.forward(config, params, tokens, mask=mask, freqs=freqs,
                                    with_aux=True, remat=remat, layers=layers)
    shares = 1 if group is None else group.size
    return causal_ce_loss(logits, tokens, mask, group) + moe_aux_weight * aux / shares


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float, *,
                         copies: Optional[Sequence[int]] = None, group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with the global norm (f32
    sums of squares over every leaf) at or above ``max_norm``, each
    gradient becomes ``(g / norm) * max_norm``; below it, each stays as it
    is. Returns the norm. No host sync on one card. On a mesh, ``group``
    is the world and ``copies[i]`` the number of its ranks that hold leaf
    i's same shard: each rank's squares are divided by it and summed over
    the world, so that each element counts once."""
    grads = list(grads)
    if group is None:
        total = sum(torch.sum(g.float().square()) for g in grads)
    else:
        total = collectives.all_reduce_sum(
            group, sum(torch.sum(g.float().square()) / n for g, n in zip(grads, copies)))
    norm = torch.sqrt(total)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, (g / norm.to(g.dtype)) * max_norm, g))
    return norm


class _Gathered(Mapping):
    """The trainer's params as the model reads them in one step: each
    leaf's shards gathered over the axes of ``gathers`` (name → [(dim,
    group, reduce)]) when it is first read (a tied embedding, read by the
    lookup and the head, once: its gradient is reduce-scattered once);
    :meth:`layers` a stacked leaf layer by layer, so that a layer's
    leaves are gathered in that layer (and again in its remat)."""

    def __init__(self, params: Dict[str, torch.Tensor], gathers) -> None:
        self.params, self.gathers = params, gathers
        self._read: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._read:
            self._read[name] = _gather(self.params[name], self.gathers.get(name, ()))
        return self._read[name]

    def __contains__(self, name) -> bool:
        return name in self.params

    def __iter__(self):
        return iter(self.params)

    def __len__(self) -> int:
        return len(self.params)

    def layers(self) -> Dict[str, Sequence]:
        return {name: _Layers(self.params[name].unbind(0),
                              [(dim - 1, group, reduce)
                               for dim, group, reduce in self.gathers.get(name, ())])
                for name in model_lib.LAYER_LEAVES if name in self.params}


class _Layers(Sequence):
    def __init__(self, parts, gathers) -> None:
        self.parts, self.gathers = parts, gathers

    def __getitem__(self, i):
        return _gather(self.parts[i], self.gathers)

    def __len__(self) -> int:
        return len(self.parts)


def _gather(tensor: torch.Tensor, gathers) -> torch.Tensor:
    for dim, group, reduce in gathers:
        tensor = collectives.gather(tensor, group, dim, reduce)
    return tensor


class Trainer:
    def __init__(
        self,
        model_config: model_lib.LlamaConfig,
        params: Dict[str, torch.Tensor],
        *,
        mesh_config: Optional[MeshConfig] = None,
        train_config: Optional[TrainConfig] = None,
        device: Any = "cuda",
    ) -> None:
        mesh = mesh_config or MeshConfig()
        validate_mesh(
            mesh, num_heads=model_config.num_heads, num_kv_heads=model_config.num_kv_heads,
            intermediate_size=model_config.intermediate_size,
            num_experts=model_config.num_experts, num_layers=model_config.num_layers,
            allow_pp=True,
        )
        model_lib.validate_family_params(model_config, params)
        self.model_config = model_config
        self.train_config = train_config or TrainConfig()
        self.device = resolve_device(device)
        self.mesh_config = mesh
        self.group = build_mesh(mesh, self.device)
        axes = model_lib.logical_axes(model_config)
        self._axes = {name: axes[name] for name in params}
        self._splits = {name: leaf_splits(self._axes[name], mesh) for name in params}
        # the trainer's own leaves (this rank's slices): the step updates
        # them in place
        self.params = {
            name: self._shard(name, leaf).detach().to(self.device, copy=True).requires_grad_()
            for name, leaf in params.items()
        }
        self.config = self._rank_config()
        self._gathers = self._gather_plan()
        self.freqs = model_lib.model_freqs(model_config, device=self.device)
        tc = self.train_config
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=tc.learning_rate, betas=(tc.b1, tc.b2),
            eps=ADAM_EPS, weight_decay=tc.weight_decay,
        )
        self.step = 0

    # ------------------------------------------------------------------ #
    # the mesh
    # ------------------------------------------------------------------ #
    def _shard(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full leaf ``name`` (the leaf itself on
        one card)."""
        return shard_leaf(leaf, self._axes[name], self.mesh_config, self.group.coords)

    def _rank_config(self):
        """The config the model runs with on this rank: the model's on one
        card and under pp (whose stages hold whole heads, and gather their
        experts); a rank config with the tp group, and a MoE model's
        groups, on the other meshes."""
        mesh, config = self.mesh_config, self.model_config
        if mesh.size == 1 or mesh.pp > 1:
            return config
        moe = None
        if config.num_experts:
            per_rank = config.num_experts // mesh.ep
            moe = model_lib.MoEGroups(share=self.group.axis("tp", "ep"),
                                      first_expert=self.group.coords["ep"] * per_rank,
                                      batch=self.group.batch)
        return model_lib.rank_config(config, self.group.tp, moe)

    def _gather_plan(self) -> Dict[str, List[Tuple[int, Any, bool]]]:
        """Per leaf, the axes it is gathered over before its use: fsdp,
        whose gradient is reduce-scattered (ZeRO-3), and under pp the
        experts over ep, whose gradient is the rank's part of the one
        every ep rank computed."""
        plan = {}
        for name, splits in self._splits.items():
            gathers = [(dim, self.group.axis("fsdp"), True) for dim, axis in splits if axis == "fsdp"]
            if self.mesh_config.pp > 1:
                gathers += [(dim, self.group.axis("ep"), False) for dim, axis in splits
                            if axis == "ep"]
            if gathers:
                plan[name] = gathers
        return plan

    def _sum_axes(self, name: str) -> Tuple[Tuple[str, ...], ...]:
        """The axes a leaf's gradient is summed over after the backward:
        the batch axes it is replicated on, then pp for a leaf the stages
        share (the embedding, final norm and head)."""
        split = {axis for _, axis in self._splits[name]}
        sums = [tuple(axis for axis in BATCH_AXES if axis not in split)]
        if self.mesh_config.pp > 1 and "pp" not in split:
            sums.append(("pp",))
        return tuple(axes for axes in sums if self.group.axis(*axes).size > 1)

    def _copies(self, name: str) -> int:
        """How many ranks of the world hold a leaf's same shard."""
        split = int(np.prod([self.mesh_config.shape[axis] for _, axis in self._splits[name]]))
        return self.mesh_config.size // split

    def _rows(self, rows: int) -> slice:
        """This rank's rows of the global batch: the batch axes' blocks in
        row-major order, as JAX's ``P(("dp", "fsdp"))`` places them."""
        batch = self.group.batch
        if rows % batch.size:
            raise ValueError(f"the batch of {rows} rows must split over dp×fsdp={batch.size}")
        part = rows // batch.size
        return slice(batch.rank * part, (batch.rank + 1) * part)

    @torch.no_grad()
    def _sync_grads(self) -> None:
        """Sum each gradient over the axes :meth:`_sum_axes` names: one
        flat f32 all-reduce per axis set, over the leaves that share it."""
        buckets: Dict[Tuple[Tuple[str, ...], ...], List[torch.Tensor]] = {}
        for name, param in self.params.items():
            if param.grad is None:  # a stage that does not use the leaf
                param.grad = torch.zeros_like(param)
            buckets.setdefault(self._sum_axes(name), []).append(param.grad)
        for sums, grads in buckets.items():
            for axes in sums:
                flat = collectives.all_reduce_sum(
                    self.group.axis(*axes), torch.cat([g.reshape(-1).float() for g in grads]))
                for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(part.view_as(g))

    def train_step(self, tokens, mask) -> float:
        """Run one step; tokens/mask are host arrays [B, T] of the global
        batch (on a mesh every rank passes the same)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool)
        mesh, tc = self.mesh_config, self.train_config
        self.optimizer.zero_grad(set_to_none=True)
        params, layers = self.params, None
        if self._gathers:
            view = _Gathered(self.params, self._gathers)
            params, layers = view, view.layers()
        if mesh.pp > 1:
            from langstream_tpu_torch.parallel.pipeline import pipelined_loss_fn

            loss = pipelined_loss_fn(
                self.config, params, tokens.to(self.device), mask.to(self.device), self.freqs,
                self.group, tc.num_microbatches or 2 * mesh.pp, moe_aux_weight=tc.moe_aux_weight,
                remat=tc.remat, layers=layers)
        else:
            rows = self._rows(tokens.shape[0])
            loss = loss_fn(self.config, params, tokens[rows].to(self.device),
                           mask[rows].to(self.device), self.freqs, remat=tc.remat,
                           moe_aux_weight=tc.moe_aux_weight,
                           group=self.group.batch if mesh.size > 1 else None, layers=layers)
            loss.backward()
            loss = collectives.all_reduce_sum(self.group.batch, loss.detach())
        if mesh.size > 1:
            self._sync_grads()
            clip_by_global_norm_([p.grad for p in self.params.values()], tc.grad_clip,
                                 copies=[self._copies(name) for name in self.params],
                                 group=self.group.world)
        else:
            clip_by_global_norm_((p.grad for p in self.params.values()), tc.grad_clip)
        self.optimizer.step()
        self.step += 1
        return float(loss)

    # ------------------------------------------------------------------ #
    # optimizer state by parameter name, in optax's terms
    # ------------------------------------------------------------------ #
    @property
    def opt_state(self) -> Dict[str, Any]:
        """AdamW's state as ``{"count": steps taken, "mu": {name:
        exp_avg}, "nu": {name: exp_avg_sq}}`` (the tensors themselves, not
        copies; empty dicts before the first step): this rank's slices."""
        state = {"count": 0, "mu": {}, "nu": {}}
        for name, param in self.params.items():
            slot = self.optimizer.state.get(param)
            if slot:
                state["count"] = int(slot["step"])
                state["mu"][name] = slot["exp_avg"]
                state["nu"][name] = slot["exp_avg_sq"]
        return state

    def _load_opt_state(self, opt_state: Dict[str, Any]) -> None:
        self.optimizer.state.clear()
        mu, nu = opt_state.get("mu", {}), opt_state.get("nu", {})
        for name, param in self.params.items():
            if name not in mu:
                continue
            self.optimizer.state[param] = {
                "step": torch.tensor(float(opt_state["count"]), dtype=torch.float32),
                "exp_avg": _placed(self._shard(name, mu[name]), param, f"mu/{name}"),
                "exp_avg_sq": _placed(self._shard(name, nu[name]), param, f"nu/{name}"),
            }

    def gathered(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The full leaves whose slices on this rank are ``tensors`` (by
        parameter name: the params, ``mu``, ``nu``, their gradients), on
        rank 0's host; an empty dict on the other ranks, which must call
        it too. One card: host copies."""
        if self.mesh_config.size == 1:
            return {name: tensor.detach().to("cpu", copy=True) for name, tensor in tensors.items()}
        import torch.distributed as dist

        rank, world = self.group.rank, self.mesh_config.size
        out = {}
        for name, tensor in tensors.items():
            shard = tensor.detach().to("cpu", copy=True).contiguous()
            parts = [torch.empty_like(shard) for _ in range(world)] if rank == 0 else None
            dist.gather(shard, parts, dst=0)
            if rank == 0:
                out[name] = _assemble(parts, self._splits[name], self.mesh_config)
        return out

    # ------------------------------------------------------------------ #
    # checkpoint / resume
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, manager, *, wait: bool = False) -> None:
        """Save (params, opt_state, step) through a
        ``training.checkpoint.CheckpointManager``: every tensor is on the
        host when this returns, the files are written behind it. On a
        mesh every rank calls it: the full leaves are gathered to rank 0,
        which saves them as one card would, and the others wait for its
        snapshot (for its write too, with ``wait``)."""
        from langstream_tpu_torch.training.checkpoint import config_meta

        meta = {"model_config": config_meta(self.model_config)}
        if self.mesh_config.size == 1:
            manager.save(self.step, self.params, self.opt_state, meta=meta)
            if wait:
                manager.wait()
            return
        import torch.distributed as dist

        state = self.opt_state
        params, mu, nu = (self.gathered(tree) for tree in (self.params, state["mu"], state["nu"]))
        if self.group.rank == 0:
            manager.save(self.step, params, {"count": state["count"], "mu": mu, "nu": nu},
                         meta=meta)
            if wait:
                manager.wait()
        dist.barrier()

    def restore_checkpoint(self, manager, step=None) -> int:
        """Restore params/opt_state/step in place (the same tensors, so
        the optimizer keeps them), each rank its slice of the full leaves
        whatever mesh wrote them. Returns the restored step."""
        if self.mesh_config.size > 1:
            import torch.distributed as dist

            # rank 0's manager knows the step it wrote last
            chosen = [manager.latest_step() if step is None and self.group.rank == 0 else step]
            if self.group.rank == 0:
                manager.wait()
            dist.broadcast_object_list(chosen, src=0)
            step = chosen[0]
        restored = manager.restore(step)
        with torch.no_grad():
            for name, param in self.params.items():
                param.copy_(_placed(self._shard(name, restored["params"][name]), param, name))
        if restored.get("opt_state") is not None:
            self._load_opt_state(restored["opt_state"])
        self.step = restored["step"]
        return self.step


def _assemble(parts: Sequence[torch.Tensor], splits, mesh: MeshConfig) -> torch.Tensor:
    """A full leaf from the world's slices (rank order): each rank's
    slice at its coordinates on the leaf's split axes."""
    shape = list(parts[0].shape)
    for dim, axis in splits:
        shape[dim] *= mesh.shape[axis]
    full = torch.empty(shape, dtype=parts[0].dtype)
    for rank, part in enumerate(parts):
        coords = mesh_coords(mesh, rank)
        index = [slice(None)] * len(shape)
        for dim, axis in splits:
            width = part.shape[dim]
            index[dim] = slice(coords[axis] * width, (coords[axis] + 1) * width)
        full[tuple(index)] = part
    return full


def _placed(tensor: torch.Tensor, like: torch.Tensor, name: str) -> torch.Tensor:
    """``tensor`` on ``like``'s device, after checking it has ``like``'s
    shape and dtype (a copy would cast silently)."""
    if tensor.shape != like.shape or tensor.dtype != like.dtype:
        raise ValueError(f"{name}: checkpoint holds {tensor.dtype} {list(tensor.shape)}, the "
                         f"trainer {like.dtype} {list(like.shape)}")
    return tensor.to(like.device)

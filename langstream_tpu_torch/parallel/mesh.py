"""The mesh: its configuration, the logical-axis rules, and the tensor
parallel group.

Port of ``langstream_tpu/parallel/mesh.py``. The JAX package shards by
SPMD from one process: a ``Mesh`` of devices, ``PartitionSpec``s from
logical axis names, and XLA inserting the collectives. The port runs one
process per rank instead (``torch.distributed``), so:

- :func:`logical_to_physical` answers, per dimension of a leaf, which
  mesh axis splits it (the JAX ``PartitionSpec``'s entries), and
  :func:`split_dim` which dimension splits over ``tp``;
- :func:`shard_params` gives this rank its contiguous slice of each leaf
  (what ``jax.device_put`` with a ``NamedSharding`` leaves on one
  device);
- :class:`TPGroup` (the counterpart of ``build_mesh``) holds the rank,
  the size and the process group, and does the two collectives the
  model needs, ``all_reduce`` (a row-sharded product's partial sums) and
  ``all_gather`` (the vocabulary's columns).

The backend follows from where the ranks sit (:func:`build_group`):
gloo where any two ranks share a card, and on the CPU; NCCL where each
rank has a card of its own. Gloo stages a card's tensors through the
host, so a collective on it synchronizes the stream.

Serving takes ``tp`` only (:func:`require_serving_mesh`); ``dp``,
``fsdp``, ``sp``, ``pp`` and ``ep`` above 1 raise, and the trainer
refuses any axis above 1 (:func:`require_single_card`). See ROADMAP.md,
A10 and A11.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

MESH_AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @classmethod
    def from_config(cls, config: Optional[Dict[str, Any]]) -> "MeshConfig":
        if not config:
            return cls()
        return cls(
            dp=int(config.get("dp", 1)),
            fsdp=int(config.get("fsdp", 1)),
            pp=int(config.get("pp", config.get("pipeline-parallelism", 1))),
            tp=int(config.get("tp", config.get("tensor-parallelism", 1))),
            sp=int(config.get("sp", 1)),
            ep=int(config.get("ep", 1)),
        )

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.pp * self.tp * self.sp * self.ep

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.fsdp, self.pp, self.tp, self.sp, self.ep)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a JAX ``Mesh.shape`` reads."""
        return dict(zip(MESH_AXES, self.axis_sizes()))


def validate_mesh(
    config: MeshConfig,
    *,
    num_heads: int,
    num_kv_heads: int,
    intermediate_size: int,
    num_experts: int = 0,
    num_layers: Optional[int] = None,
    allow_pp: bool = False,
) -> None:
    """Reject mesh/model combinations that would silently misbehave, with
    the JAX package's errors, case for case."""
    if config.tp > 1:
        for name, size in (
            ("num_kv_heads", num_kv_heads),
            ("num_heads", num_heads),
            ("intermediate_size", intermediate_size),
        ):
            if size % config.tp != 0:
                raise ValueError(f"tp={config.tp} must divide {name}={size}")
    if config.ep > 1:
        if not num_experts:
            raise ValueError(
                f"ep={config.ep} requires an MoE model (num_experts > 0); "
                "this model is dense"
            )
        if num_experts % config.ep != 0:
            raise ValueError(
                f"ep={config.ep} must divide num_experts={num_experts}"
            )
    if config.pp > 1:
        if not allow_pp:
            raise ValueError(
                f"pp={config.pp} is only supported by the pipeline trainer "
                "(parallel.pipeline); this component has no pipeline "
                "schedule — use tp/dp axes instead"
            )
        if num_layers is not None and num_layers % config.pp != 0:
            raise ValueError(
                f"pp={config.pp} must divide num_layers={num_layers}"
            )
        if config.fsdp > 1 or config.tp > 1 or config.sp > 1:
            raise ValueError(
                f"pp={config.pp} composes only with dp for now "
                f"(got fsdp={config.fsdp}, tp={config.tp}, sp={config.sp})"
            )


def require_single_card(config: Optional[MeshConfig]) -> None:
    """Refuse a mesh with any axis above 1 (the trainer: tp training
    waits on this module's group, ROADMAP.md A11)."""
    wide = {axis: size for axis, size in zip(MESH_AXES, (config or MeshConfig()).axis_sizes())
            if size > 1}
    if wide:
        raise NotImplementedError(
            f"a mesh with {wide} is not ported to langstream_tpu_torch: it runs on one card "
            "(see ROADMAP.md, A10)")


def require_serving_mesh(config: Optional[MeshConfig]) -> None:
    """Serving shards over ``tp`` only: any other axis above 1 raises."""
    wide = {axis: size for axis, size in zip(MESH_AXES, (config or MeshConfig()).axis_sizes())
            if size > 1 and axis != "tp"}
    if wide:
        raise NotImplementedError(
            f"a serving mesh with {wide} is not ported to langstream_tpu_torch: serving shards "
            "over tp only (see ROADMAP.md, A10 and A11)")


# logical axis → candidate physical axes (first that fits wins; None =
# replicated), the JAX package's table
DEFAULT_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "batch": ("dp", "fsdp"),
    "sequence": ("sp",),
    "vocab": ("tp",),
    "embed": ("fsdp",),
    "heads": ("tp",),
    "kv_heads": ("tp",),
    "head_dim": (),
    "mlp": ("tp",),
    "layers": ("pp",),
    "cache_batch": (),
    "cache_sequence": (),
    "expert": ("ep",),
}


def logical_to_physical(
    logical_axes: Sequence[Optional[str]],
    mesh: MeshConfig,
    rules: Optional[Dict[str, Tuple[Optional[str], ...]]] = None,
) -> Tuple[Optional[str], ...]:
    """The mesh axis that splits each dimension (None = replicated): the
    entries of the JAX ``PartitionSpec``, skipping axes of size 1 and
    using each mesh axis at most once."""
    rules = rules or DEFAULT_RULES
    shape = mesh.shape
    used = set()
    spec: List[Optional[str]] = []
    for logical in logical_axes:
        chosen: Optional[str] = None
        if logical is not None:
            for candidate in rules.get(logical, ()):
                if candidate is None or candidate in used:
                    continue
                if shape.get(candidate, 1) > 1:
                    chosen = candidate
                    used.add(candidate)
                    break
        spec.append(chosen)
    return tuple(spec)


class LogicalAxes:
    """The logical axis names of one parameter's dimensions."""

    __slots__ = ("names",)

    def __init__(self, *names: Optional[str]) -> None:
        self.names = tuple(names)

    def __repr__(self) -> str:
        return f"L{self.names!r}"


L = LogicalAxes


def split_dim(axes: LogicalAxes, mesh: MeshConfig, rules=None) -> Optional[int]:
    """The dimension of a leaf with ``axes`` that splits over ``tp``, or
    None when the leaf is replicated across the tp ranks."""
    spec = logical_to_physical(axes.names, mesh, rules)
    return spec.index("tp") if "tp" in spec else None


def shard_slice(tensor: torch.Tensor, dim: Optional[int], rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/``size`` of ``tensor`` along ``dim``
    (the whole tensor for ``dim`` None or ``size`` 1)."""
    if dim is None or size == 1:
        return tensor
    width = tensor.shape[dim]
    if width % size:
        raise ValueError(f"tp={size} must divide dimension {dim} of size {width}")
    part = width // size
    return tensor.narrow(dim, rank * part, part)


def head_shard(tensor: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s heads of ``tensor`` (heads on ``dim``), contiguous,
    as the attention kernels take them."""
    return shard_slice(tensor, dim, rank, size).contiguous()


def shard_params(params: Dict[str, Any], logical_axes: Dict[str, Any], mesh: MeshConfig,
                 rank: int, rules=None) -> Dict[str, Any]:
    """This rank's contiguous slice of each leaf, split as the rules split
    it over ``tp`` (a copy; a replicated leaf is returned as it is). An
    int8 leaf (``quant.QTensor``) takes axes of the same kind
    (``quant.quantize_logical_axes``): its values and scale split
    together."""
    return {name: shard_leaf(leaf, logical_axes[name], mesh, rank, rules)
            for name, leaf in params.items()}


def shard_leaf(leaf: Any, axes: Any, mesh: MeshConfig, rank: int, rules=None) -> Any:
    """One leaf of :func:`shard_params`."""
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return type(leaf)(q=shard_leaf(leaf.q, axes.q, mesh, rank, rules),
                          scale=shard_leaf(leaf.scale, axes.scale, mesh, rank, rules))
    dim = split_dim(axes, mesh, rules)
    if dim is None:
        return leaf
    # one contiguous copy: the full leaf's storage is not kept
    return shard_slice(leaf, dim, rank, mesh.tp).clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------- #
# the tensor-parallel group
# ---------------------------------------------------------------------- #
class TPGroup:
    """The ranks of one tp group: this process's ``rank`` of ``size``, the
    process group and its ``backend``, and the model's two collectives.
    Sums run in f32 whatever the tensor's dtype (each partial is rounded
    once, then added in f32), and every rank ends with the same values."""

    def __init__(self, rank: int, size: int, process_group: Any = None,
                 backend: str = "gloo") -> None:
        self.rank = rank
        self.size = size
        self.process_group = process_group
        self.backend = backend

    def __repr__(self) -> str:
        return f"TPGroup(rank={self.rank}, size={self.size}, backend={self.backend!r})"

    def _staged(self, tensor: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A fresh contiguous copy the collective may overwrite: on the
        host for gloo, on the tensor's own device for NCCL."""
        device = tensor.device if self.backend == "nccl" else torch.device("cpu")
        return tensor.detach().to(device=device, dtype=dtype, copy=True).contiguous()

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the ranks, in its dtype and device."""
        if self.size == 1:
            return tensor
        import torch.distributed as dist

        staged = self._staged(tensor, torch.float32)
        dist.all_reduce(staged, group=self.process_group)
        return staged.to(device=tensor.device, dtype=tensor.dtype)

    def all_gather(self, tensor: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' tensors concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return tensor
        import torch.distributed as dist

        staged = self._staged(tensor, tensor.dtype)
        parts = [torch.empty_like(staged) for _ in range(self.size)]
        dist.all_gather(parts, staged, group=self.process_group)
        return torch.cat(parts, dim=dim).to(tensor.device)


def _card_identity(device: torch.device) -> str:
    """Where a rank sits: the host and the card (its UUID where torch
    tells it, else its index)."""
    if device.type != "cuda":
        return f"{socket.gethostname()}:cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    return f"{socket.gethostname()}:{getattr(props, 'uuid', index)}"


def backend_for(identities: Sequence[str]) -> str:
    """gloo where any two ranks share a card, or on the CPU; NCCL where
    each rank has a card of its own."""
    if any(identity.endswith(":cpu") for identity in identities):
        return "gloo"
    return "gloo" if len(set(identities)) < len(identities) else "nccl"


def _require_ranks(mesh: MeshConfig):
    """torch.distributed, which must be up with one rank per tp shard."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh tp={mesh.tp} needs torch.distributed up with one process per rank: start the "
            "ranks with `serve --tp N` (one host) or runtime.multihost.initialize_multihost")
    world = dist.get_world_size()
    if world != mesh.tp:
        raise ValueError(f"mesh tp={mesh.tp} needs {mesh.tp} ranks, torch.distributed has {world}")
    return dist


def tp_rank(mesh: MeshConfig) -> int:
    """This process's tp rank (0 at tp=1)."""
    require_serving_mesh(mesh)
    return _require_ranks(mesh).get_rank() if mesh.tp > 1 else 0


def build_group(mesh: MeshConfig, device: Any) -> TPGroup:
    """This process's tp group over ``torch.distributed``, which must be
    up with one rank per tp shard (``runtime.multihost``). The ranks
    exchange where they sit to choose the backend; the default group is
    gloo, and an NCCL group is made beside it where each rank has its
    own card (``new_group`` is collective: every rank builds its group
    once, at the same point). tp=1 needs no process group."""
    require_serving_mesh(mesh)
    if mesh.tp == 1:
        return TPGroup(0, 1)
    dist = _require_ranks(mesh)
    identities: List[Any] = [None] * mesh.tp
    dist.all_gather_object(identities, _card_identity(torch.device(device)))
    backend = backend_for(identities)
    group = None if dist.get_backend() == backend else dist.new_group(backend=backend)
    return TPGroup(dist.get_rank(), mesh.tp, group, backend)

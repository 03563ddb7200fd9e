"""The mesh: its configuration, the logical-axis rules, and its ranks'
process groups.

Port of ``langstream_tpu/parallel/mesh.py``. The JAX package shards by
SPMD from one process: a ``Mesh`` of devices, ``PartitionSpec``s from
logical axis names, and XLA inserting the collectives. The port runs one
process per rank instead (``torch.distributed``), so:

- :func:`logical_to_physical` answers, per dimension of a leaf, which
  mesh axis splits it (the JAX ``PartitionSpec``'s entries), and
  :func:`split_dim` which dimension splits over ``tp``;
- :func:`shard_params` gives this rank its contiguous slice of each leaf
  (what ``jax.device_put`` with a ``NamedSharding`` leaves on one
  device), over ``tp`` for serving, over every axis of a training mesh;
- :func:`build_mesh` is the counterpart of JAX's ``build_mesh``: a world
  of ``mesh.size`` ranks, rank r at JAX's device position r (row-major
  over :data:`MESH_AXES`), with an :class:`AxisGroup` for each axis above
  1 and for the axis sets the step reduces over (:class:`MeshGroup`);
  :func:`build_group` builds serving's tp group alone, whose world is
  its tp ranks. The model's collectives over a group are
  ``parallel.collectives``' functions: ``reduce_sum`` (a row-sharded
  product's partial sums), ``gather`` (the vocabulary's columns) and
  ``enter`` (a replicated activation entering the sharded region), with
  the backward each implies, so a forward under autograd trains.

The backend follows from where the ranks sit (:func:`backend_for`):
gloo where any two ranks share a card, and on the CPU; NCCL where each
rank has a card of its own. Gloo stages a card's tensors through the
host, so a collective on it synchronizes the stream.

Serving takes ``tp`` only (:func:`require_serving_mesh`; ROADMAP.md,
A10); the trainer takes every mesh JAX's takes
(``validate_mesh(..., allow_pp=True)``).
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def shard_slice(tensor: torch.Tensor, dim: Optional[int], rank: int, size: int,
                axis: str = "tp") -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/``size`` of ``tensor`` along ``dim``
    (the whole tensor for ``dim`` None or ``size`` 1)."""
    if dim is None or size == 1:
        return tensor
    width = tensor.shape[dim]
    if width % size:
        raise ValueError(f"{axis}={size} must divide dimension {dim} of size {width}")
    part = width // size
    return tensor.narrow(dim, rank * part, part)


def head_shard(tensor: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s heads of ``tensor`` (heads on ``dim``), contiguous,
    as the attention kernels take them."""
    return shard_slice(tensor, dim, rank, size).contiguous()


def shard_params(params: Dict[str, Any], logical_axes: Dict[str, Any], mesh: MeshConfig,
                 rank: Any, rules=None) -> Dict[str, Any]:
    """This rank's contiguous slice of each leaf, split as the rules split
    it (a copy; a replicated leaf is returned as it is). ``rank`` is the
    tp rank of a serving mesh, or this rank's coordinates by axis
    (:meth:`MeshGroup.coords`) on a training mesh, which splits over every
    axis. An int8 leaf (``quant.QTensor``) takes axes of the same kind
    (``quant.quantize_logical_axes``): its values and scale split
    together."""
    return {name: shard_leaf(leaf, logical_axes[name], mesh, rank, rules)
            for name, leaf in params.items()}


def shard_leaf(leaf: Any, axes: Any, mesh: MeshConfig, rank: int, rules=None) -> Any:
    """One leaf of :func:`shard_params`."""
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        return type(leaf)(q=shard_leaf(leaf.q, axes.q, mesh, rank, rules),
                          scale=shard_leaf(leaf.scale, axes.scale, mesh, rank, rules))
    coords = rank if isinstance(rank, Mapping) else {"tp": rank}
    splits = leaf_splits(axes, mesh, rules)
    if not splits:
        return leaf
    for dim, axis in splits:
        leaf = shard_slice(leaf, dim, coords.get(axis, 0), mesh.shape[axis], axis)
    # one contiguous copy: the full leaf's storage is not kept
    return leaf.clone(memory_format=torch.contiguous_format)


def leaf_splits(axes: LogicalAxes, mesh: MeshConfig, rules=None) -> List[Tuple[int, str]]:
    """(dimension, mesh axis) of each split dimension of a leaf with
    ``axes``, in dimension order."""
    spec = logical_to_physical(axes.names, mesh, rules)
    return [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]


# ---------------------------------------------------------------------- #
# the ranks' groups
# ---------------------------------------------------------------------- #
class AxisGroup:
    """The ranks of one mesh axis, or of a set of axes, that share every
    other coordinate: this process's ``rank`` of ``size`` (row-major over
    the axes), the process group (None: the default group) and its
    ``backend``. ``parallel.collectives`` runs the model's collectives
    over it."""

    def __init__(self, rank: int, size: int, process_group: Any = None,
                 backend: str = "gloo") -> None:
        self.rank = rank
        self.size = size
        self.process_group = process_group
        self.backend = backend

    def __repr__(self) -> str:
        return f"AxisGroup(rank={self.rank}, size={self.size}, backend={self.backend!r})"


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


def build_group(mesh: MeshConfig, device: Any) -> AxisGroup:
    """This process's tp group over ``torch.distributed``, which must be
    up with one rank per tp shard (``runtime.multihost``). The ranks
    exchange where they sit to choose the backend; the default group is
    gloo, and an NCCL group is made beside it where each rank has its
    own card (``new_group`` is collective: every rank builds its group
    once, at the same point). tp=1 needs no process group."""
    require_serving_mesh(mesh)
    if mesh.tp == 1:
        return AxisGroup(0, 1)
    dist = _require_ranks(mesh)
    identities: List[Any] = [None] * mesh.tp
    dist.all_gather_object(identities, _card_identity(torch.device(device)))
    backend = backend_for(identities)
    group = None if dist.get_backend() == backend else dist.new_group(backend=backend)
    return AxisGroup(dist.get_rank(), mesh.tp, group, backend)


# ---------------------------------------------------------------------- #
# the training mesh: a world of mesh.size ranks
# ---------------------------------------------------------------------- #
def mesh_coords(mesh: MeshConfig, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis: JAX's device order,
    row-major over :data:`MESH_AXES` (``build_mesh`` reshapes the device
    list to the axis sizes)."""
    coords = {}
    for axis, size in reversed(list(zip(MESH_AXES, mesh.axis_sizes()))):
        rank, coords[axis] = divmod(rank, size)
    return {axis: coords[axis] for axis in MESH_AXES}


def axis_members(mesh: MeshConfig, axes: Sequence[str], rank: int) -> List[int]:
    """The ranks that share every coordinate of ``rank`` outside
    ``axes``, in row-major order over ``axes``."""
    mine = mesh_coords(mesh, rank)
    return [other for other in range(mesh.size)
            if all(c == mine[axis] for axis, c in mesh_coords(mesh, other).items()
                   if axis not in axes)]


class MeshGroup:
    """This process's place in a training world of ``mesh.size`` ranks:
    its ``rank``, its ``coords`` by axis, the ``backend``, and an
    :class:`AxisGroup` for each set of axes :meth:`axis` is asked for
    (built by :func:`build_mesh`; a set whose axes are all of size 1 is
    a group of one)."""

    def __init__(self, mesh: MeshConfig, rank: int, groups: Dict[Tuple[str, ...], AxisGroup],
                 backend: str = "gloo") -> None:
        self.mesh = mesh
        self.rank = rank
        self.coords = mesh_coords(mesh, rank)
        self.backend = backend
        self._groups = groups

    def __repr__(self) -> str:
        return f"MeshGroup({self.mesh}, rank={self.rank}, backend={self.backend!r})"

    def axis(self, *axes: str) -> AxisGroup:
        """The group over ``axes`` (those of size 1 left out)."""
        key = tuple(axis for axis in MESH_AXES if axis in axes and self.mesh.shape[axis] > 1)
        if not key:
            return AxisGroup(0, 1, backend=self.backend)
        return self._groups[key]

    @property
    def tp(self) -> AxisGroup:
        return self.axis("tp")

    @property
    def batch(self) -> AxisGroup:
        """The batch axes ``(dp, fsdp)``: the rows of the global batch
        split over them in JAX's order."""
        return self.axis(*BATCH_AXES)

    @property
    def world(self) -> AxisGroup:
        return self.axis(*MESH_AXES)


# the logical batch axis's mesh axes (DEFAULT_RULES["batch"])
BATCH_AXES = ("dp", "fsdp")
# the sets of axes a train step reduces over, beside each axis alone:
# the batch, the MoE MLP's shares (tp × ep), and the whole world
AXIS_SETS = (BATCH_AXES, ("tp", "ep"), MESH_AXES)


def build_mesh(mesh: MeshConfig, device: Any) -> MeshGroup:
    """This process's :class:`MeshGroup` over ``torch.distributed``,
    which must be up with ``mesh.size`` ranks (``parallel.launch``,
    ``runtime.multihost``); a mesh of size 1 needs none. The ranks
    exchange where they sit to choose the backend, then every rank makes
    every group, in the same order (``new_group`` is collective over the
    world): one for each axis above 1 and for each set of
    :data:`AXIS_SETS` with two or more such axes. The world itself is the
    default group where its backend is the one chosen."""
    if mesh.size == 1:
        return MeshGroup(mesh, 0, {})
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {mesh} needs torch.distributed up with one process per rank: start the ranks "
            "with parallel.launch (one host) or runtime.multihost.initialize_multihost")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {mesh} needs {mesh.size} ranks, torch.distributed has {world}")
    rank = dist.get_rank()
    identities: List[Any] = [None] * world
    dist.all_gather_object(identities, _card_identity(torch.device(device)))
    backend = backend_for(identities)
    wide = [axis for axis in MESH_AXES if mesh.shape[axis] > 1]
    keys = [(axis,) for axis in wide]
    for axes in AXIS_SETS:
        key = tuple(axis for axis in axes if axis in wide)
        if len(key) > 1 and key not in keys:
            keys.append(key)
    groups: Dict[Tuple[str, ...], AxisGroup] = {}
    for key in keys:
        blocks = sorted({tuple(axis_members(mesh, key, other)) for other in range(world)})
        for members in blocks:
            if len(members) == world and dist.get_backend() == backend:
                process_group = None
            else:
                process_group = dist.new_group(list(members), backend=backend)
            if rank in members:
                groups[key] = AxisGroup(members.index(rank), len(members), process_group, backend)
    return MeshGroup(mesh, rank, groups, backend)


def param_shardings(logical_axes: Dict[str, Any], mesh: MeshConfig,
                    rules=None) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each leaf's split by dimension (the mesh axis, or None where it is
    replicated): the entries of the ``PartitionSpec`` JAX's
    ``param_shardings`` places it with."""
    return {name: logical_to_physical(axes.names, mesh, rules) for name, axes in logical_axes.items()}

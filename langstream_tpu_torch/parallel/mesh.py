"""The mesh's configuration.

Port of ``MeshConfig`` from ``langstream_tpu/parallel/mesh.py``: the axis
sizes (``dp``, ``fsdp``, ``pp``, ``tp``, ``sp``, ``ep``) and how a config
mapping spells them. The port runs on one card, so it takes a mesh of
size 1 and refuses any axis above 1 (:func:`require_single_card`). Mesh
construction, the logical-axis rules and sharding are not ported
(ROADMAP.md, A10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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


def require_single_card(config: Optional[MeshConfig]) -> None:
    """Refuse a mesh with any axis above 1: the port has no mesh."""
    wide = {axis: size for axis, size in zip(MESH_AXES, (config or MeshConfig()).axis_sizes())
            if size > 1}
    if wide:
        raise NotImplementedError(
            f"a mesh with {wide} is not ported to langstream_tpu_torch: it runs on one card "
            "(see ROADMAP.md, A10)")

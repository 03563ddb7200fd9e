"""Parallelism over torch.distributed: the mesh, its ranks' groups and the
logical-axis rules (``mesh.py``), the collectives of training with their
backward (``collectives.py``), the GPipe schedule over ``pp``
(``pipeline.py``), sequence parallelism's two schedules (``ring.py``,
``ulysses.py``), and the ranks of one host (``launch.py``). The exports
are the JAX package's ``parallel`` exports."""

from langstream_tpu_torch.parallel.mesh import (
    L,
    LogicalAxes,
    MeshConfig,
    build_mesh,
    logical_to_physical,
    param_shardings,
    shard_params,
)
from langstream_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipelined_logits,
    pipelined_loss_fn,
)
from langstream_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from langstream_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = [
    "L",
    "LogicalAxes",
    "MeshConfig",
    "build_mesh",
    "logical_to_physical",
    "param_shardings",
    "shard_params",
    "pipeline_apply",
    "pipelined_logits",
    "pipelined_loss_fn",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
]

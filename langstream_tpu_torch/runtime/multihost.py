"""Multi-host bootstrap: one replica's ranks across several pods, and the
ranks of one host.

Port of ``langstream_tpu/runtime/multihost.py``. A model served under
tensor parallelism, or trained on a mesh, runs one process per rank;
every rank must join one ``torch.distributed`` group before it touches
the model. The operator's
StatefulSet gives each pod a stable name, ``{sts}-{ordinal}``, behind a
headless service, and ``LANGSTREAM_HOSTS_PER_REPLICA`` (H) groups pods
``r*H .. r*H+H-1`` into replica ``r``, whose local rank 0 is the
coordinator. :func:`plan_from_statefulset` derives (replica, rank,
coordinator) from the pod's hostname, as the JAX package does, and
:func:`initialize_multihost` brings the group up at the coordinator's
address (where the JAX package calls ``jax.distributed.initialize``).
Single-host replicas (H == 1) are a no-op.

On one host, ``serve --tp N`` starts its N−1 follower ranks itself and
each rank calls :func:`initialize_distributed` with the leader's address
(``cli/main.py``).

The default group is gloo; ``parallel.mesh.build_group`` (serving) and
``build_mesh`` (training) add NCCL groups where each rank has a card of
its own. Every collective and the
rendezvous itself wait at most ``timeout_s``: a rank that died fails its
peers instead of leaving them waiting.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
import socket
from typing import Optional

logger = logging.getLogger(__name__)

_ORDINAL = re.compile(r"^(?P<base>.+)-(?P<ordinal>\d+)$")

# seconds a rendezvous or a collective waits for the other ranks
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MultihostPlan:
    replica: int            # data-parallel replica this pod belongs to
    process_id: int         # rank within the replica (0..H-1)
    num_processes: int      # H
    coordinator: str        # host:port of the replica's rank-0 pod

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def plan_from_statefulset(
    hostname: Optional[str] = None,
    *,
    hosts_per_replica: Optional[int] = None,
    namespace: Optional[str] = None,
    service: Optional[str] = None,
    port: int = 8476,
) -> Optional[MultihostPlan]:
    """The replica's topology from StatefulSet identity; None when this
    pod is a single-host replica (H <= 1)."""
    hosts = int(
        hosts_per_replica
        if hosts_per_replica is not None
        else os.environ.get("LANGSTREAM_HOSTS_PER_REPLICA", "1")
    )
    if hosts <= 1:
        return None
    hostname = hostname or os.environ.get("HOSTNAME", "")
    match = _ORDINAL.match(hostname)
    if not match:
        raise ValueError(
            f"multi-host replica needs a StatefulSet ordinal hostname, "
            f"got {hostname!r}"
        )
    base = match.group("base")
    ordinal = int(match.group("ordinal"))
    replica, process_id = divmod(ordinal, hosts)
    namespace = namespace or os.environ.get(
        "LANGSTREAM_NAMESPACE", "default"
    )
    # the headless service shares the StatefulSet's name
    service = service or base
    coordinator_pod = f"{base}-{replica * hosts}"
    coordinator = (
        f"{coordinator_pod}.{service}.{namespace}.svc:{port}"
    )
    return MultihostPlan(
        replica=replica,
        process_id=process_id,
        num_processes=hosts,
        coordinator=coordinator,
    )


def initialize_distributed(rank: int, world_size: int, address: str,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the gloo default group of ``world_size`` ranks whose store
    rank 0 serves at ``address`` (``host:port``)."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{address}", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def initialize_multihost(plan: Optional[MultihostPlan] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Bring up ``torch.distributed`` for this pod's replica when needed.
    Returns True when it ran."""
    if plan is None:
        plan = plan_from_statefulset()
    if plan is None:
        return False
    logger.info(
        "multi-host replica %d: rank %d/%d, coordinator %s",
        plan.replica, plan.process_id, plan.num_processes, plan.coordinator,
    )
    initialize_distributed(plan.process_id, plan.num_processes, plan.coordinator, timeout_s)
    return True


def free_port(host: str = "127.0.0.1") -> int:
    """A TCP port nothing listens on now, for a rendezvous on this host."""
    with socket.socket() as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]

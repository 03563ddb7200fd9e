"""Start the ranks of one host: a tensor-parallel serving group, or a
training world of ``mesh.size`` ranks (``training.Trainer`` with a
``mesh_config``; ``parallel.mesh.build_mesh`` makes its groups).

The calling process is rank 0. :func:`spawn_ranks` starts ranks 1 .. N−1
as ``python -m langstream_tpu_torch.parallel.launch MODULE:FUNCTION``,
each with its rank, the group's size, the rendezvous address, its device
and a JSON payload in its environment; :func:`main` (the child) joins the
gloo group (``runtime.multihost.initialize_distributed``) and calls
``FUNCTION(rank, world_size, device, payload)``. ``serve --tp N`` starts
its followers so (``cli.main.follow``), one card each; a trainer's caller
starts every rank so (``ranks=range(N)``). A caller that names the same
card for two ranks shares it (they then talk over gloo).

Each rank waits at most ``timeout_s`` for the rendezvous and for every
collective, so a rank that dies fails the others instead of hanging
them; :func:`stop_ranks` ends the children that outlive their time.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

from langstream_tpu_torch.runtime.multihost import DEFAULT_TIMEOUT_S, initialize_distributed

ENV_RANK = "LANGSTREAM_TP_RANK"
ENV_WORLD = "LANGSTREAM_TP_WORLD"
ENV_ADDRESS = "LANGSTREAM_TP_ADDRESS"
ENV_DEVICE = "LANGSTREAM_TP_DEVICE"
ENV_PAYLOAD = "LANGSTREAM_TP_PAYLOAD"
ENV_TIMEOUT = "LANGSTREAM_TP_TIMEOUT_S"
GLOO_IFNAME = "GLOO_SOCKET_IFNAME"

# the directory that holds the package: a child imports it from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spawn_ranks(target: str, payload: Dict[str, Any], devices: Sequence[str], address: str,
                timeout_s: float = DEFAULT_TIMEOUT_S, ranks: Optional[Sequence[int]] = None,
                path: Sequence[str] = (), **popen) -> List[subprocess.Popen]:
    """Start ranks 1 .. len(devices)−1 (or ``ranks``) running ``target``
    (``"module:function"``, importable from the package's root or the
    directories of ``path``), rank r on ``devices[r]``; the caller is
    rank 0 and joins the group itself, unless ``ranks`` names 0 too.
    Returns the children."""
    world = len(devices)
    children = []
    for rank in ranks if ranks is not None else range(1, world):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, (_ROOT, *path, env.get("PYTHONPATH"))))
        # the ranks of one host talk over the loopback interface
        env.setdefault(GLOO_IFNAME, "lo")
        env.update({ENV_RANK: str(rank), ENV_WORLD: str(world), ENV_ADDRESS: address,
                    ENV_DEVICE: str(devices[rank]), ENV_PAYLOAD: json.dumps(payload),
                    ENV_TIMEOUT: str(timeout_s)})
        children.append(subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.parallel.launch", target], env=env,
            **popen))
    return children


def stop_ranks(children: Sequence[subprocess.Popen], timeout_s: float = 60.0) -> List[int]:
    """Wait up to ``timeout_s`` for each child to exit, kill the ones
    that do not, and return their exit codes."""
    codes = []
    for child in children:
        try:
            codes.append(child.wait(timeout=timeout_s))
        except subprocess.TimeoutExpired:
            child.kill()
            codes.append(child.wait())
    return codes


def main(argv: Sequence[str]) -> None:
    module, _, function = argv[0].partition(":")
    rank, world = int(os.environ[ENV_RANK]), int(os.environ[ENV_WORLD])
    initialize_distributed(rank, world, os.environ[ENV_ADDRESS],
                           float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT_S)))
    target = getattr(importlib.import_module(module), function)
    try:
        target(rank, world, os.environ[ENV_DEVICE], json.loads(os.environ[ENV_PAYLOAD]))
    finally:
        import torch.distributed as dist

        # a target may leave the world itself (for worlds of its own)
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

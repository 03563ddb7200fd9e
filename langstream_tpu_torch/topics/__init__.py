"""Topic (broker) runtimes of the port.

The port's own copy of ``langstream_tpu/topics/__init__.py``'s registry:
look up a runtime by the ``streamingCluster.type`` of ``instance.yaml``.
The port carries the in-process ``memory`` broker (``topics/memory.py``),
the transport of the single-process runner; ``noop`` and ``none`` name it
too. The JAX package's ``kafka``, ``pulsar``, ``pravega`` and ``tpulog``
brokers are not ported: :func:`create_topic_runtime` refuses them with
an error that names the broker.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from langstream_tpu_torch.api.topics import TopicConnectionsRuntime

NOT_PORTED = ("kafka", "pulsar", "pravega", "tpulog")

_FACTORIES: Dict[str, Callable[[Dict[str, Any]], TopicConnectionsRuntime]] = {}


def register_topic_runtime(
    name: str, factory: Callable[[Dict[str, Any]], TopicConnectionsRuntime]
) -> None:
    """Register a runtime factory; it receives the
    ``streamingCluster.configuration`` dict."""
    _FACTORIES[name] = factory


def create_topic_runtime(streaming_cluster: Dict[str, Any]) -> TopicConnectionsRuntime:
    kind = (streaming_cluster or {}).get("type", "memory")
    if kind in ("noop", "none"):
        kind = "memory"
    factory = _FACTORIES.get(kind)
    if factory is None:
        if kind in NOT_PORTED:
            raise ValueError(
                f"streaming cluster type {kind!r} is not yet ported to langstream_tpu_torch; "
                f"the port runs apps on the in-process broker (type: memory)"
            )
        raise ValueError(
            f"unknown streaming cluster type {kind!r}; known: {sorted(_FACTORIES)}"
        )
    return factory((streaming_cluster or {}).get("configuration", {}) or {})


def _make_memory(configuration: Dict[str, Any]) -> TopicConnectionsRuntime:
    from langstream_tpu_torch.topics.memory import MemoryTopicConnectionsRuntime

    return MemoryTopicConnectionsRuntime()


register_topic_runtime("memory", _make_memory)

"""Topic (broker) runtimes of the port.

The port's own copy of ``langstream_tpu/topics/__init__.py``'s registry:
look up a runtime by the ``streamingCluster.type`` of ``instance.yaml``.
The port carries:

- ``memory`` — the in-process broker (``topics/memory.py``), the transport
  of the single-process runner; ``noop`` and ``none`` name it too;
- ``tpulog`` — the durable partitioned log broker (``topics/log/``, its
  segments on the native store of ``native/logstore.cpp``): with a
  ``directory`` configuration embedded in-process, with an ``address``
  the served broker (``python -m langstream_tpu_torch broker DIR``) of a
  multi-process app;
- ``kafka`` — the Kafka wire-protocol client (``topics/kafka/``), against a
  Kafka cluster or the port's own ``KafkaFacadeBroker``.

The JAX package's ``pulsar`` and ``pravega`` brokers are not ported:
:func:`create_topic_runtime` refuses them with an error that names the
broker and the ROADMAP item they wait for.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from langstream_tpu_torch.api.topics import TopicConnectionsRuntime

# the JAX package's brokers the port refuses by name (ROADMAP A7.4: they
# talk to services neither the CPU tests nor the card's machine have)
NOT_PORTED = ("pulsar", "pravega")

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
                f"streaming cluster type {kind!r} is not yet ported to langstream_tpu_torch "
                f"(ROADMAP A7.4: Pulsar and Pravega); the port runs apps on memory, tpulog "
                f"or kafka"
            )
        raise ValueError(
            f"unknown streaming cluster type {kind!r}; known: {sorted(_FACTORIES)}"
        )
    return factory((streaming_cluster or {}).get("configuration", {}) or {})


def _make_memory(configuration: Dict[str, Any]) -> TopicConnectionsRuntime:
    from langstream_tpu_torch.topics.memory import MemoryTopicConnectionsRuntime

    return MemoryTopicConnectionsRuntime()


def _make_tpulog(configuration: Dict[str, Any]) -> TopicConnectionsRuntime:
    if configuration.get("address"):
        from langstream_tpu_torch.topics.log.client import RemoteTopicConnectionsRuntime

        return RemoteTopicConnectionsRuntime(configuration["address"])
    directory = configuration.get("directory")
    if not directory:
        raise ValueError(
            "tpulog streamingCluster needs a configuration with either "
            "'address' (served broker) or 'directory' (embedded broker); "
            f"got {sorted(configuration)}"
        )
    from langstream_tpu_torch.topics.log.broker import LogTopicConnectionsRuntime

    return LogTopicConnectionsRuntime(root=str(directory))


def _make_kafka(configuration: Dict[str, Any]) -> TopicConnectionsRuntime:
    from langstream_tpu_torch.topics.kafka.runtime import KafkaTopicConnectionsRuntime

    return KafkaTopicConnectionsRuntime(configuration)


register_topic_runtime("memory", _make_memory)
register_topic_runtime("tpulog", _make_tpulog)
register_topic_runtime("kafka", _make_kafka)

"""Broker-portable topic SPI.

The port's own copy of ``langstream_tpu/api/topics.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's topic contracts
(``langstream-api/src/main/java/ai/langstream/api/runner/topics/TopicConnectionsRuntime.java:23``,
``TopicConsumer.java:22``, ``TopicProducer.java:22``, ``TopicReader.java:18``,
``TopicAdmin.java:18``, ``TopicOffsetPosition.java``): consumers join a group
and share partitions; producers write; readers tail a topic without a group
(the gateway uses them); admin creates/deletes topics.

All data methods are coroutines (see ``api.agent`` module docstring for the
asyncio-first rationale).
"""

from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api.records import Record


class OffsetPosition(enum.Enum):
    """Where a reader starts (``TopicOffsetPosition.java``)."""

    EARLIEST = "earliest"
    LATEST = "latest"


@dataclasses.dataclass(frozen=True)
class TopicSpec:
    """Planner-level topic description (``model/TopicDefinition.java:30``)."""

    name: str
    partitions: int = 1
    creation_mode: str = "create-if-not-exists"  # or "none"
    deletion_mode: str = "none"  # or "delete"
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    implicit: bool = False
    # declared value schema ({type: avro, schema: "<json>"}) — flows to
    # schema-aware producers (Kafka + registry → Confluent framing)
    schema: Optional[Dict[str, Any]] = None


class TopicProducer(abc.ABC):
    @abc.abstractmethod
    async def write(self, record: Record) -> None:
        """Durably publish one record (await = broker ack)."""

    async def start(self) -> None:
        ...

    async def close(self) -> None:
        ...

    @property
    def topic(self) -> str:
        raise NotImplementedError

    def total_in(self) -> int:
        """Records written so far (metrics parity with the reference's
        producer counters)."""
        return 0


class TopicConsumer(abc.ABC):
    @abc.abstractmethod
    async def read(self, max_records: int = 100, timeout: float = 0.1) -> List[Record]:
        """Poll the next batch for this group member."""

    @abc.abstractmethod
    async def commit(self, records: List[Record]) -> None:
        """Acknowledge ``records``. Out-of-order acks are allowed; the
        implementation must only advance the durable offset up to the
        contiguous watermark (reference:
        ``langstream-kafka-runtime/.../KafkaConsumerWrapper.java:52-230``)."""

    async def start(self) -> None:
        ...

    async def close(self) -> None:
        ...

    def total_out(self) -> int:
        return 0


class TopicReader(abc.ABC):
    """Group-less tailing reader (gateway consume path,
    ``TopicReader.java:18``)."""

    @abc.abstractmethod
    async def read(self, max_records: int = 100, timeout: float = 0.1) -> List[Record]:
        ...

    async def start(self) -> None:
        ...

    async def close(self) -> None:
        ...


class TopicAdmin(abc.ABC):
    @abc.abstractmethod
    async def create_topic(self, spec: TopicSpec) -> None:
        ...

    @abc.abstractmethod
    async def delete_topic(self, name: str) -> None:
        ...

    async def close(self) -> None:
        ...


class TopicConnectionsRuntime(abc.ABC):
    """Factory for consumers/producers/readers/admin against one broker
    (``TopicConnectionsRuntime.java:23-36``)."""

    @abc.abstractmethod
    def create_consumer(
        self,
        agent_id: str,
        config: Dict[str, Any],
    ) -> TopicConsumer:
        """``config`` carries at least ``topic`` and ``group``."""

    @abc.abstractmethod
    def create_producer(
        self,
        agent_id: str,
        config: Dict[str, Any],
    ) -> TopicProducer:
        ...

    @abc.abstractmethod
    def create_reader(
        self,
        config: Dict[str, Any],
        initial_position: OffsetPosition = OffsetPosition.LATEST,
    ) -> TopicReader:
        ...

    @abc.abstractmethod
    def create_admin(self) -> TopicAdmin:
        ...

    def create_deadletter_producer(
        self, agent_id: str, config: Dict[str, Any]
    ) -> Optional[TopicProducer]:
        """Producer for ``<topic>-deadletter`` (reference:
        ``KafkaTopicConnectionsRuntime.createDeadletterTopicProducer``);
        None when the runtime has no dead-letter support."""
        topic = config.get("topic")
        if not topic:
            return None
        return self.create_producer(agent_id, {**config, "topic": f"{topic}-deadletter"})

    async def init(self, streaming_cluster_config: Dict[str, Any]) -> None:
        ...

    async def close(self) -> None:
        ...

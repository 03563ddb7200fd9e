"""In-process broker with Kafka-like semantics.

The port's own copy of ``langstream_tpu/topics/memory.py`` (the port imports nothing
of the JAX package).

The default transport for local runs and tests. Semantics modelled on the
reference's Kafka data plane
(``langstream-kafka-runtime/src/main/java/ai/langstream/kafka/runner/``):

- Topics have N partitions; records are routed by ``hash(key) % N`` when a
  key is present, round-robin otherwise (Kafka default partitioner shape).
- Consumers join a *group*; partitions are split across group members, and a
  member joining/leaving triggers a rebalance with redelivery of uncommitted
  records (reference: ``KafkaConsumerWrapper.onPartitionsRevoked``,
  ``KafkaConsumerWrapper.java:82-111``).
- Commits may arrive out of order (async sink completions); the durable
  offset only advances over the *contiguous* prefix of acknowledged offsets
  — the reference's TreeSet watermark logic
  (``KafkaConsumerWrapper.java:52-230``).
- Readers tail a topic without a group (gateway consume path).

Everything is asyncio-native and lock-free from the caller's perspective:
one event loop, plain data structures, ``asyncio.Condition`` for blocking
polls.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Set, Tuple

from langstream_tpu_torch.api.records import Record, now_millis
from langstream_tpu_torch.api.topics import (
    OffsetPosition,
    TopicAdmin,
    TopicConsumer,
    TopicConnectionsRuntime,
    TopicProducer,
    TopicReader,
    TopicSpec,
)


@dataclasses.dataclass(frozen=True)
class BrokerRecord(Record):
    """A record as delivered by the broker: carries its coordinates so a
    later :meth:`MemoryTopicConsumer.commit` can locate the offset (the
    reference wraps ConsumerRecords the same way)."""

    partition: int = 0
    offset: int = -1


class _Partition:
    __slots__ = ("records", "base")

    def __init__(self) -> None:
        self.records: List[BrokerRecord] = []
        self.base = 0  # offset of records[0] (for future truncation)

    def append(self, record: Record, topic: str, partition: int) -> BrokerRecord:
        offset = self.base + len(self.records)
        stored = BrokerRecord(
            value=record.value,
            key=record.key,
            origin=topic,
            timestamp=record.timestamp or now_millis(),
            headers=record.headers,
            partition=partition,
            offset=offset,
        )
        self.records.append(stored)
        return stored

    def end_offset(self) -> int:
        return self.base + len(self.records)

    def fetch(self, start: int, limit: int) -> List[BrokerRecord]:
        idx = start - self.base
        if idx < 0:
            idx = 0
        return self.records[idx : idx + limit]


class _Topic:
    def __init__(self, spec: TopicSpec) -> None:
        self.spec = spec
        self.partitions = [_Partition() for _ in range(max(1, spec.partitions))]
        self._rr = itertools.count()

    def route(self, record: Record) -> int:
        if record.key is not None:
            key = record.key
            if isinstance(key, (dict, list)):
                key = repr(key)
            return hash(key) % len(self.partitions)
        return next(self._rr) % len(self.partitions)


class _GroupState:
    """Per consumer-group state: committed watermarks + membership."""

    def __init__(self, n_partitions: int) -> None:
        self.committed = [0] * n_partitions
        self.members: List["MemoryTopicConsumer"] = []
        self.generation = 0

    def assignment(self, member: "MemoryTopicConsumer") -> List[int]:
        if member not in self.members:
            return []
        n = len(self.members)
        i = self.members.index(member)
        return [p for p in range(len(self.committed)) if p % n == i]


class MemoryBroker:
    """One in-process broker instance (≈ one Kafka cluster)."""

    def __init__(self) -> None:
        self.topics: Dict[str, _Topic] = {}
        self.groups: Dict[Tuple[str, str], _GroupState] = {}
        self._data_available = asyncio.Condition()

    # -------------------------------------------------------------- #
    # admin
    # -------------------------------------------------------------- #
    def ensure_topic(self, name: str, partitions: int = 1) -> _Topic:
        topic = self.topics.get(name)
        if topic is None:
            topic = _Topic(TopicSpec(name=name, partitions=partitions))
            self.topics[name] = topic
        return topic

    def create_topic(self, spec: TopicSpec) -> None:
        if spec.name not in self.topics:
            self.topics[spec.name] = _Topic(spec)

    def delete_topic(self, name: str) -> None:
        self.topics.pop(name, None)
        for key in [k for k in self.groups if k[0] == name]:
            self.groups.pop(key)

    def group(self, topic: str, group_id: str) -> _GroupState:
        key = (topic, group_id)
        state = self.groups.get(key)
        topic_obj = self.ensure_topic(topic)
        if state is None:
            state = _GroupState(len(topic_obj.partitions))
            self.groups[key] = state
        return state

    # -------------------------------------------------------------- #
    # data
    # -------------------------------------------------------------- #
    async def publish(self, topic_name: str, record: Record) -> BrokerRecord:
        topic = self.ensure_topic(topic_name)
        partition = topic.route(record)
        stored = topic.partitions[partition].append(record, topic_name, partition)
        async with self._data_available:
            self._data_available.notify_all()
        return stored

    async def wait_for_data(self, timeout: float) -> None:
        try:
            async with self._data_available:
                await asyncio.wait_for(self._data_available.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    def stats(self) -> Dict[str, Any]:
        return {
            name: {
                "partitions": len(t.partitions),
                "records": sum(p.end_offset() - p.base for p in t.partitions),
            }
            for name, t in self.topics.items()
        }


class MemoryTopicProducer(TopicProducer):
    def __init__(self, broker: MemoryBroker, topic: str) -> None:
        self._broker = broker
        self._topic = topic
        self._count = 0

    @property
    def topic(self) -> str:
        return self._topic

    async def write(self, record: Record) -> None:
        await self._broker.publish(self._topic, record)
        self._count += 1

    def total_in(self) -> int:
        return self._count


class MemoryTopicConsumer(TopicConsumer):
    """Group member with out-of-order ack tracking.

    Watermark logic per partition (reference
    ``KafkaConsumerWrapper.java:52-230``): ``next_fetch`` advances on read;
    ``acked`` collects out-of-order acknowledgements; ``committed`` (stored
    on the group) only advances while the next offset is in ``acked``.
    """

    def __init__(self, broker: MemoryBroker, topic: str, group_id: str) -> None:
        self._broker = broker
        self._topic = topic
        self._group_id = group_id
        self._next_fetch: Dict[int, int] = {}
        self._acked: Dict[int, Set[int]] = {}
        self._generation = -1
        self._count = 0
        self._started = False

    # -- membership ------------------------------------------------- #
    async def start(self) -> None:
        group = self._broker.group(self._topic, self._group_id)
        if self not in group.members:
            group.members.append(self)
            group.generation += 1
        self._started = True

    async def close(self) -> None:
        group = self._broker.group(self._topic, self._group_id)
        if self in group.members:
            group.members.remove(self)
            group.generation += 1
        self._started = False

    def _sync_generation(self, group: _GroupState) -> None:
        if self._generation != group.generation:
            # Rebalance: drop local fetch positions; uncommitted records will
            # be redelivered from the committed watermark (Kafka semantics).
            self._next_fetch = {}
            self._acked = {}
            self._generation = group.generation

    # -- data ------------------------------------------------------- #
    async def read(self, max_records: int = 100, timeout: float = 0.1) -> List[Record]:
        if not self._started:
            await self.start()
        batch = self._poll(max_records)
        if batch:
            return batch
        await self._broker.wait_for_data(timeout)
        return self._poll(max_records)

    def _poll(self, max_records: int) -> List[Record]:
        group = self._broker.group(self._topic, self._group_id)
        self._sync_generation(group)
        topic = self._broker.ensure_topic(self._topic)
        out: List[Record] = []
        for partition_id in group.assignment(self):
            if len(out) >= max_records:
                break
            start = self._next_fetch.get(
                partition_id, group.committed[partition_id]
            )
            fetched = topic.partitions[partition_id].fetch(
                start, max_records - len(out)
            )
            if fetched:
                self._next_fetch[partition_id] = fetched[-1].offset + 1
                out.extend(fetched)
        self._count += len(out)
        return out

    async def commit(self, records: List[Record]) -> None:
        group = self._broker.group(self._topic, self._group_id)
        self._sync_generation(group)
        for record in records:
            if not isinstance(record, BrokerRecord):
                continue
            acked = self._acked.setdefault(record.partition, set())
            acked.add(record.offset)
            # advance the contiguous watermark
            watermark = group.committed[record.partition]
            while watermark in acked:
                acked.discard(watermark)
                watermark += 1
            group.committed[record.partition] = watermark

    def committed_offsets(self) -> List[int]:
        group = self._broker.group(self._topic, self._group_id)
        return list(group.committed)

    def total_out(self) -> int:
        return self._count


class MemoryTopicReader(TopicReader):
    def __init__(
        self,
        broker: MemoryBroker,
        topic: str,
        initial_position: OffsetPosition,
    ) -> None:
        self._broker = broker
        self._topic = topic
        self._initial = initial_position
        self._positions: Optional[Dict[int, int]] = None

    async def start(self) -> None:
        topic = self._broker.ensure_topic(self._topic)
        if self._initial is OffsetPosition.EARLIEST:
            self._positions = {p: 0 for p in range(len(topic.partitions))}
        else:
            self._positions = {
                p: topic.partitions[p].end_offset()
                for p in range(len(topic.partitions))
            }

    async def read(self, max_records: int = 100, timeout: float = 0.1) -> List[Record]:
        if self._positions is None:
            await self.start()
        batch = self._poll(max_records)
        if batch:
            return batch
        await self._broker.wait_for_data(timeout)
        return self._poll(max_records)

    def _poll(self, max_records: int) -> List[Record]:
        assert self._positions is not None
        topic = self._broker.ensure_topic(self._topic)
        out: List[Record] = []
        for partition_id in range(len(topic.partitions)):
            if len(out) >= max_records:
                break
            start = self._positions.setdefault(partition_id, 0)
            fetched = topic.partitions[partition_id].fetch(
                start, max_records - len(out)
            )
            if fetched:
                self._positions[partition_id] = fetched[-1].offset + 1
                out.extend(fetched)
        return out


class MemoryTopicAdmin(TopicAdmin):
    def __init__(self, broker: MemoryBroker) -> None:
        self._broker = broker

    async def create_topic(self, spec: TopicSpec) -> None:
        self._broker.create_topic(spec)

    async def delete_topic(self, name: str) -> None:
        self._broker.delete_topic(name)


class MemoryTopicConnectionsRuntime(TopicConnectionsRuntime):
    """Factory bound to one :class:`MemoryBroker`.

    By default every runtime instance owns a private broker; the local
    application runner passes one shared broker so all agents of an app see
    the same topics.
    """

    def __init__(self, broker: Optional[MemoryBroker] = None) -> None:
        self.broker = broker or MemoryBroker()

    def create_consumer(self, agent_id: str, config: Dict[str, Any]) -> TopicConsumer:
        return MemoryTopicConsumer(
            self.broker,
            topic=config["topic"],
            group_id=config.get("group", f"langstream-agent-{agent_id}"),
        )

    def create_producer(self, agent_id: str, config: Dict[str, Any]) -> TopicProducer:
        return MemoryTopicProducer(self.broker, topic=config["topic"])

    def create_reader(
        self,
        config: Dict[str, Any],
        initial_position: OffsetPosition = OffsetPosition.LATEST,
    ) -> TopicReader:
        return MemoryTopicReader(self.broker, config["topic"], initial_position)

    def create_admin(self) -> TopicAdmin:
        return MemoryTopicAdmin(self.broker)

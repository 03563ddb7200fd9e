"""Durable broker ("tpulog") — the framework's own Kafka-role data plane.

The reference delegates durable inter-agent transport to an external broker
(Kafka/Pulsar/Pravega, SURVEY §2.5); this framework ships its own: an
embedded, file-backed, partitioned log broker whose storage core is native
C++ (``langstream_tpu_torch/native/logstore.cpp``) and whose consumer semantics
mirror the reference's Kafka wrapper
(``langstream-kafka-runtime/.../KafkaConsumerWrapper.java:52-230``):

- records are routed to partitions by a *stable* key hash (crc32) so that
  session affinity survives across processes and restarts;
- consumers join a group; partitions are split across members; membership
  changes bump the group generation and uncommitted records are redelivered
  from the committed watermark;
- commits may arrive out of order; the durable committed offset advances
  only over the contiguous prefix of acknowledged offsets, and is persisted
  (the reference stores this in Kafka's __consumer_offsets);
- a ``<topic>-deadletter`` producer is available for the error policies.

Run it embedded (one process owns the files) or behind the TCP server
(``langstream_tpu_torch/topics/log/server.py``) for multi-process apps.

The port's own copy of ``langstream_tpu/topics/log/broker.py``: the same
directory layout (``<topic>/meta.json``, ``<topic>/partition-<p>/``
segments, ``__groups__/<group>@<topic>.json`` watermarks), so that either
package reads what the other wrote.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import pathlib
import tempfile
import threading
import urllib.parse
import zlib
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
from langstream_tpu_torch.topics.log import codec
from langstream_tpu_torch.topics.log.store import (
    DEFAULT_SEGMENT_BYTES,
    open_partition_log,
)
from langstream_tpu_torch.topics.memory import BrokerRecord


def stable_partition(key: Any, n_partitions: int) -> int:
    """Deterministic cross-process key -> partition routing."""
    if isinstance(key, bytes):
        data = key
    elif isinstance(key, str):
        data = key.encode("utf-8")
    else:
        data = repr(key).encode("utf-8")
    return zlib.crc32(data) % n_partitions


def _atomic_write_json(path: pathlib.Path, doc: Any) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _LogTopic:
    def __init__(self, root: pathlib.Path, spec: TopicSpec, segment_bytes: int):
        self.spec = spec
        self.dir = root / spec.name
        self.dir.mkdir(parents=True, exist_ok=True)
        meta = self.dir / "meta.json"
        if not meta.exists():
            _atomic_write_json(
                meta, {"partitions": max(1, spec.partitions)}
            )
        n = json.loads(meta.read_text())["partitions"]
        self.partitions = [
            open_partition_log(str(self.dir / f"partition-{p}"), segment_bytes)
            for p in range(n)
        ]
        self._rr = itertools.count()

    def route(self, record: Record) -> int:
        if record.key is not None:
            return stable_partition(record.key, len(self.partitions))
        return next(self._rr) % len(self.partitions)

    def close(self) -> None:
        for p in self.partitions:
            p.close()


class _LogGroupState:
    """Group membership (in-memory) + committed watermarks (persisted)."""

    def __init__(self, path: pathlib.Path, n_partitions: int):
        self.path = path
        self.members: List[Any] = []  # member tokens (consumer objects or ids)
        self.generation = 0
        if path.exists():
            stored = json.loads(path.read_text())
            self.committed = [
                int(x) for x in stored.get("committed", [0] * n_partitions)
            ]
            while len(self.committed) < n_partitions:
                self.committed.append(0)
        else:
            self.committed = [0] * n_partitions

    def persist(self) -> None:
        _atomic_write_json(self.path, {"committed": self.committed})

    def assignment(self, member: Any) -> List[int]:
        if member not in self.members:
            return []
        n = len(self.members)
        i = self.members.index(member)
        return [p for p in range(len(self.committed)) if p % n == i]


class LogBroker:
    """One durable broker instance rooted at a directory."""

    def __init__(
        self,
        root: str,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        default_partitions: int = 1,
    ) -> None:
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._segment_bytes = segment_bytes
        self._default_partitions = default_partitions
        self.topics: Dict[str, _LogTopic] = {}
        self.groups: Dict[Tuple[str, str], _LogGroupState] = {}
        self._lock = threading.Lock()
        self._data_available = asyncio.Condition()
        # recover topics already on disk
        for entry in self.root.iterdir():
            if entry.is_dir() and not entry.name.startswith("__"):
                self.ensure_topic(entry.name)

    # -- admin ------------------------------------------------------- #
    def ensure_topic(self, name: str, partitions: Optional[int] = None) -> _LogTopic:
        with self._lock:
            topic = self.topics.get(name)
            if topic is None:
                topic = _LogTopic(
                    self.root,
                    TopicSpec(
                        name=name,
                        partitions=partitions or self._default_partitions,
                    ),
                    self._segment_bytes,
                )
                self.topics[name] = topic
            return topic

    def create_topic(self, spec: TopicSpec) -> None:
        self.ensure_topic(spec.name, spec.partitions)

    def delete_topic(self, name: str) -> None:
        with self._lock:
            topic = self.topics.pop(name, None)
            if topic is not None:
                topic.close()
            for key in [k for k in self.groups if k[0] == name]:
                self.groups.pop(key)
        # retain files on disk (Kafka delete is async too); a fresh
        # create_topic with the same name resumes from the old log.

    def group(self, topic_name: str, group_id: str) -> _LogGroupState:
        with self._lock:
            key = (topic_name, group_id)
            state = self.groups.get(key)
            if state is None:
                topic = self.topics.get(topic_name)
            else:
                return state
        topic = topic or self.ensure_topic(topic_name)
        with self._lock:
            state = self.groups.get(key)
            if state is None:
                # percent-encode each part so the separator '@' (which
                # quote() always escapes) can't collide with characters
                # inside group or topic names — "a__b"/"c" and "a"/"b__c"
                # must not share a watermark file.
                safe = (
                    urllib.parse.quote(group_id, safe="")
                    + "@"
                    + urllib.parse.quote(topic_name, safe="")
                )
                state = _LogGroupState(
                    self.root / "__groups__" / f"{safe}.json",
                    len(topic.partitions),
                )
                self.groups[key] = state
            return state

    # -- data -------------------------------------------------------- #
    async def publish(self, topic_name: str, record: Record) -> BrokerRecord:
        topic = self.ensure_topic(topic_name)
        partition = topic.route(record)
        stored = BrokerRecord(
            value=record.value,
            key=record.key,
            origin=topic_name,
            timestamp=record.timestamp or now_millis(),
            headers=record.headers,
            partition=partition,
            offset=0,
        )
        payload = codec.encode_record(stored)
        offset = topic.partitions[partition].append(payload)
        stored = BrokerRecord(
            value=stored.value,
            key=stored.key,
            origin=stored.origin,
            timestamp=stored.timestamp,
            headers=stored.headers,
            partition=partition,
            offset=offset,
        )
        async with self._data_available:
            self._data_available.notify_all()
        return stored

    def fetch(
        self, topic_name: str, partition: int, start: int, max_records: int
    ) -> List[BrokerRecord]:
        topic = self.ensure_topic(topic_name)
        raw = topic.partitions[partition].read_batch(start, max_records)
        out = []
        for offset, payload in raw:
            record = codec.decode_record(payload, topic_name)
            out.append(
                BrokerRecord(
                    value=record.value,
                    key=record.key,
                    origin=topic_name,
                    timestamp=record.timestamp,
                    headers=record.headers,
                    partition=partition,
                    offset=offset,
                )
            )
        return out

    def end_offsets(self, topic_name: str) -> List[int]:
        topic = self.ensure_topic(topic_name)
        return [p.end_offset() for p in topic.partitions]

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
                "end_offsets": [p.end_offset() for p in t.partitions],
            }
            for name, t in self.topics.items()
        }

    def close(self) -> None:
        with self._lock:
            for topic in self.topics.values():
                topic.close()
            self.topics.clear()


class LogTopicProducer(TopicProducer):
    def __init__(self, broker: LogBroker, topic: str) -> None:
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


class LogTopicConsumer(TopicConsumer):
    """Durable group member with out-of-order ack watermarking (embedded)."""

    def __init__(self, broker: LogBroker, topic: str, group_id: str) -> None:
        self._broker = broker
        self._topic = topic
        self._group_id = group_id
        self._next_fetch: Dict[int, int] = {}
        self._acked: Dict[int, Set[int]] = {}
        self._generation = -1
        self._count = 0
        self._started = False

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

    def _sync_generation(self, group: _LogGroupState) -> None:
        if self._generation != group.generation:
            self._next_fetch = {}
            self._acked = {}
            self._generation = group.generation

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
        out: List[Record] = []
        for partition_id in group.assignment(self):
            if len(out) >= max_records:
                break
            start = self._next_fetch.get(
                partition_id, group.committed[partition_id]
            )
            fetched = self._broker.fetch(
                self._topic, partition_id, start, max_records - len(out)
            )
            if fetched:
                self._next_fetch[partition_id] = fetched[-1].offset + 1
                out.extend(fetched)
        self._count += len(out)
        return out

    async def commit(self, records: List[Record]) -> None:
        group = self._broker.group(self._topic, self._group_id)
        self._sync_generation(group)
        dirty = False
        for record in records:
            if not isinstance(record, BrokerRecord):
                continue
            acked = self._acked.setdefault(record.partition, set())
            acked.add(record.offset)
            watermark = group.committed[record.partition]
            while watermark in acked:
                acked.discard(watermark)
                watermark += 1
            if watermark != group.committed[record.partition]:
                group.committed[record.partition] = watermark
                dirty = True
        if dirty:
            group.persist()

    def committed_offsets(self) -> List[int]:
        group = self._broker.group(self._topic, self._group_id)
        return list(group.committed)

    def total_out(self) -> int:
        return self._count


class LogTopicReader(TopicReader):
    def __init__(
        self, broker: LogBroker, topic: str, initial_position: OffsetPosition
    ) -> None:
        self._broker = broker
        self._topic = topic
        self._initial = initial_position
        self._positions: Optional[Dict[int, int]] = None

    async def start(self) -> None:
        ends = self._broker.end_offsets(self._topic)
        if self._initial is OffsetPosition.EARLIEST:
            self._positions = {p: 0 for p in range(len(ends))}
        else:
            self._positions = dict(enumerate(ends))

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
        out: List[Record] = []
        for partition_id in list(self._positions):
            if len(out) >= max_records:
                break
            fetched = self._broker.fetch(
                self._topic,
                partition_id,
                self._positions[partition_id],
                max_records - len(out),
            )
            if fetched:
                self._positions[partition_id] = fetched[-1].offset + 1
                out.extend(fetched)
        return out


class LogTopicAdmin(TopicAdmin):
    def __init__(self, broker: LogBroker) -> None:
        self._broker = broker

    async def create_topic(self, spec: TopicSpec) -> None:
        self._broker.create_topic(spec)

    async def delete_topic(self, name: str) -> None:
        self._broker.delete_topic(name)


class LogTopicConnectionsRuntime(TopicConnectionsRuntime):
    """Embedded durable runtime: one process owns the broker directory.

    ``streamingCluster.configuration.directory`` selects the root. For
    multi-process apps use the served variant
    (:class:`langstream_tpu_torch.topics.log.client.RemoteTopicConnectionsRuntime`).
    """

    def __init__(self, broker: Optional[LogBroker] = None, root: Optional[str] = None):
        if broker is None:
            broker = LogBroker(root or tempfile.mkdtemp(prefix="tpulog-"))
        self.broker = broker

    def create_consumer(self, agent_id: str, config: Dict[str, Any]) -> TopicConsumer:
        return LogTopicConsumer(
            self.broker,
            topic=config["topic"],
            group_id=config.get("group", f"langstream-agent-{agent_id}"),
        )

    def create_producer(self, agent_id: str, config: Dict[str, Any]) -> TopicProducer:
        return LogTopicProducer(self.broker, topic=config["topic"])

    def create_reader(
        self,
        config: Dict[str, Any],
        initial_position: OffsetPosition = OffsetPosition.LATEST,
    ) -> TopicReader:
        return LogTopicReader(self.broker, config["topic"], initial_position)

    def create_admin(self) -> TopicAdmin:
        return LogTopicAdmin(self.broker)

    async def init(self, streaming_cluster_config: Dict[str, Any]) -> None:
        ...

    async def close(self) -> None:
        self.broker.close()

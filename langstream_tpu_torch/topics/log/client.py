"""Client runtime for the served tpulog broker.

``RemoteTopicConnectionsRuntime`` implements the broker-portable topic SPI
(``langstream_tpu_torch/api/topics.py``) over the TCP protocol of
``langstream_tpu_torch/topics/log/server.py`` — the moral equivalent of the
reference's Kafka client wrappers
(``langstream-kafka-runtime/.../KafkaTopicConnectionsRuntime.java:53``).

Configured from ``streamingCluster`` YAML as::

    streamingCluster:
      type: tpulog
      configuration:
        address: "127.0.0.1:4551"

Each consumer/producer/reader owns its own connection (one in-flight
request per connection; the server is happy with many connections).

The port's own copy of ``langstream_tpu/topics/log/client.py``: the same
wire protocol, so the port's client talks to the JAX package's
``BrokerServer`` and the reverse.
"""

from __future__ import annotations

import asyncio
import json
import struct
import uuid
from typing import Any, Dict, List, Optional, Set

from langstream_tpu_torch.api.records import Record
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
from langstream_tpu_torch.topics.memory import BrokerRecord

_LEN = struct.Struct("<I")


class BrokerConnection:
    def __init__(self, host: str, port: int) -> None:
        self._host = host
        self._port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def _ensure(self) -> None:
        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await asyncio.open_connection(
                self._host, self._port
            )

    async def request(self, message: Dict[str, Any]) -> Dict[str, Any]:
        async with self._lock:
            await self._ensure()
            assert self._reader is not None and self._writer is not None
            payload = json.dumps(message, default=str).encode()
            try:
                self._writer.write(_LEN.pack(len(payload)) + payload)
                await self._writer.drain()
                header = await self._reader.readexactly(_LEN.size)
                (length,) = _LEN.unpack(header)
                body = await self._reader.readexactly(length)
            except (OSError, asyncio.IncompleteReadError):
                # A clean broker FIN leaves the transport half-open
                # (is_closing() stays False), so _ensure would keep
                # reusing the dead socket — drop it so the next request
                # reconnects.
                self._writer.close()
                self._writer = None
                self._reader = None
                raise
        response = json.loads(body)
        if not response.get("ok"):
            raise RuntimeError(
                f"broker error for op {message.get('op')!r}: "
                f"{response.get('error')}"
            )
        return response

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self._reader = None


def _parse_address(address: str) -> tuple:
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


class RemoteTopicProducer(TopicProducer):
    def __init__(self, conn: BrokerConnection, topic: str) -> None:
        self._conn = conn
        self._topic = topic
        self._count = 0

    @property
    def topic(self) -> str:
        return self._topic

    async def write(self, record: Record) -> None:
        await self._conn.request(
            {
                "op": "produce",
                "topic": self._topic,
                "record": codec.record_to_json(record),
            }
        )
        self._count += 1

    def total_in(self) -> int:
        return self._count

    async def close(self) -> None:
        await self._conn.close()


class RemoteTopicConsumer(TopicConsumer):
    """Group member against the served broker.

    The server owns membership + the commit watermark; the client tracks
    fetch positions per assigned partition, resetting to the committed
    watermark whenever the group generation changes (rebalance redelivery).
    """

    def __init__(
        self, conn: BrokerConnection, topic: str, group_id: str
    ) -> None:
        self._conn = conn
        self._topic = topic
        self._group = group_id
        self._member = uuid.uuid4().hex
        self._generation = -1
        self._assignment: List[int] = []
        self._next_fetch: Dict[int, int] = {}
        self._pending_acks: Dict[int, Set[int]] = {}
        self._count = 0
        self._started = False

    async def start(self) -> None:
        response = await self._conn.request(
            {
                "op": "join",
                "topic": self._topic,
                "group": self._group,
                "member": self._member,
            }
        )
        self._apply_poll(response)
        self._started = True

    async def close(self) -> None:
        if self._started:
            try:
                await self._conn.request(
                    {
                        "op": "leave",
                        "topic": self._topic,
                        "group": self._group,
                        "member": self._member,
                    }
                )
            except (RuntimeError, OSError, asyncio.IncompleteReadError):
                pass
        await self._conn.close()
        self._started = False

    def _apply_poll(self, response: Dict[str, Any]) -> None:
        generation = response["generation"]
        if generation != self._generation:
            self._generation = generation
            self._assignment = list(response["assignment"])
            committed = response["committed"]
            self._next_fetch = {
                p: committed[p] for p in self._assignment
            }

    async def read(self, max_records: int = 100, timeout: float = 0.1) -> List[Record]:
        if not self._started:
            await self.start()
        response = await self._conn.request(
            {
                "op": "poll",
                "topic": self._topic,
                "group": self._group,
                "member": self._member,
            }
        )
        self._apply_poll(response)
        if not self._assignment:
            await asyncio.sleep(min(timeout, 0.05))
            return []
        response = await self._conn.request(
            {
                "op": "fetch",
                "topic": self._topic,
                "positions": {
                    str(p): self._next_fetch.get(p, 0) for p in self._assignment
                },
                "max_records": max_records,
                "timeout": timeout,
            }
        )
        records = [codec.record_from_json(doc) for doc in response["records"]]
        for record in records:
            assert isinstance(record, BrokerRecord)
            self._next_fetch[record.partition] = record.offset + 1
        self._count += len(records)
        return records

    async def commit(self, records: List[Record]) -> None:
        offsets: Dict[str, List[int]] = {}
        for record in records:
            if isinstance(record, BrokerRecord):
                offsets.setdefault(str(record.partition), []).append(
                    record.offset
                )
        if not offsets:
            return
        await self._conn.request(
            {
                "op": "commit",
                "topic": self._topic,
                "group": self._group,
                "member": self._member,
                "offsets": offsets,
            }
        )

    def total_out(self) -> int:
        return self._count


class RemoteTopicReader(TopicReader):
    def __init__(
        self,
        conn: BrokerConnection,
        topic: str,
        initial_position: OffsetPosition,
    ) -> None:
        self._conn = conn
        self._topic = topic
        self._initial = initial_position
        self._positions: Optional[Dict[int, int]] = None

    async def start(self) -> None:
        response = await self._conn.request(
            {"op": "end_offsets", "topic": self._topic}
        )
        ends = response["ends"]
        if self._initial is OffsetPosition.EARLIEST:
            self._positions = {p: 0 for p in range(len(ends))}
        else:
            self._positions = dict(enumerate(ends))

    async def read(self, max_records: int = 100, timeout: float = 0.1) -> List[Record]:
        if self._positions is None:
            await self.start()
        assert self._positions is not None
        response = await self._conn.request(
            {
                "op": "fetch",
                "topic": self._topic,
                "positions": {str(p): s for p, s in self._positions.items()},
                "max_records": max_records,
                "timeout": timeout,
            }
        )
        records = [codec.record_from_json(doc) for doc in response["records"]]
        for record in records:
            assert isinstance(record, BrokerRecord)
            self._positions[record.partition] = record.offset + 1
        return records

    async def close(self) -> None:
        await self._conn.close()


class RemoteTopicAdmin(TopicAdmin):
    def __init__(self, conn: BrokerConnection) -> None:
        self._conn = conn

    async def create_topic(self, spec: TopicSpec) -> None:
        await self._conn.request(
            {
                "op": "create_topic",
                "spec": {"name": spec.name, "partitions": spec.partitions},
            }
        )

    async def delete_topic(self, name: str) -> None:
        await self._conn.request({"op": "delete_topic", "topic": name})

    async def close(self) -> None:
        await self._conn.close()


class RemoteTopicConnectionsRuntime(TopicConnectionsRuntime):
    def __init__(self, address: str = "127.0.0.1:4551") -> None:
        self._host, self._port = _parse_address(address)

    def _connect(self) -> BrokerConnection:
        return BrokerConnection(self._host, self._port)

    def create_consumer(self, agent_id: str, config: Dict[str, Any]) -> TopicConsumer:
        return RemoteTopicConsumer(
            self._connect(),
            topic=config["topic"],
            group_id=config.get("group", f"langstream-agent-{agent_id}"),
        )

    def create_producer(self, agent_id: str, config: Dict[str, Any]) -> TopicProducer:
        return RemoteTopicProducer(self._connect(), topic=config["topic"])

    def create_reader(
        self,
        config: Dict[str, Any],
        initial_position: OffsetPosition = OffsetPosition.LATEST,
    ) -> TopicReader:
        return RemoteTopicReader(
            self._connect(), config["topic"], initial_position
        )

    def create_admin(self) -> TopicAdmin:
        return RemoteTopicAdmin(self._connect())

    async def init(self, streaming_cluster_config: Dict[str, Any]) -> None:
        address = streaming_cluster_config.get("address")
        if address:
            self._host, self._port = _parse_address(address)

"""Asyncio Kafka client core: connections, metadata, API calls.

One :class:`KafkaClient` per topic runtime; it owns one
:class:`KafkaConnection` per broker node and the cluster metadata. All
request/response codecs live here, pinned to the versions documented in
``protocol.py``.

The port's own copy of ``langstream_tpu/topics/kafka/client.py``.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from langstream_tpu_torch.topics.kafka import protocol as proto
from langstream_tpu_torch.topics.kafka.protocol import (
    KafkaProtocolError,
    Reader,
    Writer,
)

logger = logging.getLogger(__name__)


class KafkaVersionError(KafkaProtocolError):
    """The broker does not serve the protocol versions this client
    pins (broker older than ~0.11, or newer than the KIP-896 floor —
    Kafka 4.0 removed pre-2.1 request versions). Raised at connect by
    the ApiVersions handshake, never mid-traffic."""

    def __init__(self, broker: str, problems: List[str]) -> None:
        super().__init__(
            proto.NONE,
            f"broker {broker} does not support pinned protocol "
            f"versions: {', '.join(problems)}. Supported broker range: "
            "Apache Kafka 0.11 .. 3.x (KIP-896 removed these versions "
            "in 4.0).",
        )
        self.problems = problems


class KafkaConnection:
    """One framed request/response socket. Kafka guarantees in-order
    responses per connection, so a FIFO of pending futures suffices.

    ``connect`` performs the ApiVersions handshake (v0 — the bootstrap
    version every broker answers) and verifies each pinned API version
    against the broker's advertised ranges, so version skew fails
    loudly at connect (reference relies on the Apache client's
    identical NetworkClient handshake)."""

    def __init__(
        self,
        host: str,
        port: int,
        client_id: str,
        verify_versions: bool = True,
    ) -> None:
        self.host, self.port = host, port
        self.client_id = client_id
        self.verify_versions = verify_versions
        self.api_versions: Optional[Dict[int, Tuple[int, int]]] = None
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._correlation = itertools.count(1)
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        if self._writer is not None:
            return
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        if self.verify_versions and self.api_versions is None:
            try:
                await self._version_handshake()
            except BaseException:
                await self.close()
                raise

    async def _version_handshake(self, timeout: float = 30.0) -> None:
        """ApiVersions v0 round trip directly on the fresh socket (the
        caller may already hold the request lock)."""
        correlation_id = next(self._correlation)
        frame = proto.encode_request(
            proto.API_VERSIONS, 0, correlation_id, self.client_id, b""
        )
        self._writer.write(frame)
        await self._writer.drain()
        size_bytes = await asyncio.wait_for(
            self._reader.readexactly(4), timeout
        )
        payload = await asyncio.wait_for(
            self._reader.readexactly(int.from_bytes(size_bytes, "big")),
            timeout,
        )
        reader = Reader(payload)
        got = reader.int32()
        if got != correlation_id:
            raise KafkaProtocolError(
                proto.NONE,
                f"ApiVersions correlation mismatch {got} != {correlation_id}",
            )
        advertised = proto.decode_api_versions(reader)
        error_code = advertised.pop(-1)[0]
        if error_code != proto.NONE:
            raise KafkaProtocolError(
                error_code, "ApiVersions request rejected"
            )
        self.api_versions = advertised
        problems = proto.unsupported_pinned_apis(advertised)
        if problems:
            raise KafkaVersionError(f"{self.host}:{self.port}", problems)

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None
            self._reader = None
            # re-handshake on reconnect: the broker behind this address
            # may have been upgraded while we were away
            self.api_versions = None

    async def call(
        self, api_key: int, api_version: int, body: bytes,
        timeout: float = 30.0,
    ) -> Reader:
        async with self._lock:  # serialize request/response pairs
            await self.connect()
            correlation_id = next(self._correlation)
            frame = proto.encode_request(
                api_key, api_version, correlation_id, self.client_id, body
            )
            try:
                self._writer.write(frame)
                await self._writer.drain()
                size_bytes = await asyncio.wait_for(
                    self._reader.readexactly(4), timeout
                )
                size = int.from_bytes(size_bytes, "big")
                payload = await asyncio.wait_for(
                    self._reader.readexactly(size), timeout
                )
            except (
                asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError, OSError,
            ):
                # a timed-out request leaves its response in flight; the
                # connection is desynced — drop it so the next call
                # reconnects instead of reading the stale frame
                await self.close()
                raise
            reader = Reader(payload)
            got = reader.int32()
            if got != correlation_id:
                await self.close()
                raise KafkaProtocolError(
                    proto.NONE,
                    f"correlation mismatch {got} != {correlation_id}",
                )
            return reader


class BrokerInfo:
    __slots__ = ("node_id", "host", "port")

    def __init__(self, node_id: int, host: str, port: int) -> None:
        self.node_id, self.host, self.port = node_id, host, port


class KafkaClient:
    def __init__(
        self,
        bootstrap_servers: str,
        *,
        client_id: str = "langstream-tpu",
        verify_versions: bool = True,
    ) -> None:
        self.verify_versions = verify_versions
        self.bootstrap: List[Tuple[str, int]] = []
        for part in bootstrap_servers.split(","):
            part = part.strip()
            if ":" in part:
                host, _, port = part.rpartition(":")
                self.bootstrap.append((host or "127.0.0.1", int(port)))
            else:
                self.bootstrap.append((part, 9092))  # Kafka default port
        self.client_id = client_id
        self.brokers: Dict[int, BrokerInfo] = {}
        self.controller_id: int = -1
        # topic -> partition -> leader node id
        self.leaders: Dict[str, Dict[int, int]] = {}
        self._connections: Dict[Any, KafkaConnection] = {}

    # -- connections ---------------------------------------------------- #
    def _bootstrap_connection(self) -> KafkaConnection:
        key = ("bootstrap", *self.bootstrap[0])
        if key not in self._connections:
            host, port = self.bootstrap[0]
            self._connections[key] = KafkaConnection(
                host, port, self.client_id,
                verify_versions=self.verify_versions,
            )
        return self._connections[key]

    def node_connection(self, node_id: int) -> KafkaConnection:
        broker = self.brokers[node_id]
        if node_id not in self._connections:
            self._connections[node_id] = KafkaConnection(
                broker.host, broker.port, self.client_id,
                verify_versions=self.verify_versions,
            )
        return self._connections[node_id]

    def dedicated_connection(self, node_id: int) -> KafkaConnection:
        """A private (uncached) connection. Each consumer keeps its own
        coordinator channel so one member's join (which blocks inside the
        broker's rebalance barrier) never serializes another member's —
        the same one-socket-per-consumer layout real clients use."""
        broker = self.brokers[node_id]
        return KafkaConnection(
            broker.host, broker.port, self.client_id,
            verify_versions=self.verify_versions,
        )

    async def close(self) -> None:
        for connection in self._connections.values():
            await connection.close()
        self._connections.clear()

    # -- metadata (v1) --------------------------------------------------- #
    async def refresh_metadata(self, topics: Optional[List[str]] = None) -> None:
        body = Writer()
        if topics is None:
            body.int32(-1)
        else:
            body.array(topics, lambda w, t: w.string(t))
        reader = await self._bootstrap_connection().call(
            proto.METADATA, 1, body.build()
        )
        brokers = {}
        for _ in range(reader.int32()):
            node_id = reader.int32()
            host = reader.string()
            port = reader.int32()
            reader.string()  # rack
            brokers[node_id] = BrokerInfo(node_id, host, port)
        self.brokers = brokers
        self.controller_id = reader.int32()
        for _ in range(reader.int32()):
            error = reader.int16()
            name = reader.string()
            reader.boolean()  # is_internal
            partitions: Dict[int, int] = {}
            for _p in range(reader.int32()):
                reader.int16()  # partition error
                partition = reader.int32()
                leader = reader.int32()
                reader.array(lambda r: r.int32())  # replicas
                reader.array(lambda r: r.int32())  # isr
                partitions[partition] = leader
            if error == proto.NONE:
                self.leaders[name] = partitions

    async def leader_for(self, topic: str, partition: int) -> int:
        for _ in range(5):
            leader = self.leaders.get(topic, {}).get(partition, -1)
            if leader >= 0 and leader in self.brokers:
                return leader
            await self.refresh_metadata([topic])
            await asyncio.sleep(0.1)
        raise KafkaProtocolError(
            proto.NOT_LEADER_FOR_PARTITION, f"{topic}/{partition}"
        )

    async def partitions_for(self, topic: str) -> List[int]:
        if topic not in self.leaders:
            await self.refresh_metadata([topic])
        return sorted(self.leaders.get(topic, {}))

    # -- produce (v3) ----------------------------------------------------- #
    async def produce(
        self, topic: str, partition: int, record_set: bytes,
        acks: int = -1, timeout_ms: int = 30000,
    ) -> int:
        """Returns the base offset assigned by the broker."""
        for attempt in range(5):
            leader = await self.leader_for(topic, partition)
            body = (
                Writer()
                .string(None)        # transactional id
                .int16(acks)
                .int32(timeout_ms)
                .array([None], lambda w, _: (
                    w.string(topic),
                    w.array([None], lambda w2, _2: (
                        w2.int32(partition),
                        w2.bytes_(record_set),
                    )),
                ))
                .build()
            )
            reader = await self.node_connection(leader).call(
                proto.PRODUCE, 3, body
            )
            error = base_offset = None
            for _ in range(reader.int32()):
                reader.string()
                for _p in range(reader.int32()):
                    reader.int32()
                    error = reader.int16()
                    base_offset = reader.int64()
                    reader.int64()  # log append time
            reader.int32()  # throttle
            if error == proto.NONE:
                return base_offset
            if error in proto.RETRIABLE and attempt < 4:
                await self.refresh_metadata([topic])
                await asyncio.sleep(0.1 * (attempt + 1))
                continue
            raise KafkaProtocolError(error, f"produce {topic}/{partition}")
        raise KafkaProtocolError(proto.NONE, "produce retries exhausted")

    # -- fetch (v4) -------------------------------------------------------- #
    async def fetch(
        self, topic: str, partition: int, offset: int,
        max_wait_ms: int = 100, min_bytes: int = 1,
        max_bytes: int = 4 * 1024 * 1024,
    ) -> Tuple[List[proto.KafkaRecord], int]:
        """Single-partition fetch → (records, high_watermark)."""
        result = await self.fetch_multi(
            topic, {partition: offset}, max_wait_ms=max_wait_ms,
            min_bytes=min_bytes, max_bytes=max_bytes,
        )
        return result.get(partition, ([], -1))

    async def fetch_multi(
        self, topic: str, offsets: Dict[int, int],
        max_wait_ms: int = 100, min_bytes: int = 1,
        max_bytes: int = 4 * 1024 * 1024,
    ) -> Dict[int, Tuple[List[proto.KafkaRecord], int]]:
        """Fetch MANY partitions in one request per leader (idle-partition
        long-polls overlap instead of serializing — a consumer assigned P
        partitions pays one wait, not P). Returns
        {partition: (records, high_watermark)}."""
        by_leader: Dict[int, List[int]] = {}
        for partition in offsets:
            leader = await self.leader_for(topic, partition)
            by_leader.setdefault(leader, []).append(partition)

        out: Dict[int, Tuple[List[proto.KafkaRecord], int]] = {}

        async def fetch_from(leader: int, partitions: List[int]) -> None:
            body = (
                Writer()
                .int32(-1)           # replica id
                .int32(max_wait_ms)
                .int32(min_bytes)
                .int32(max_bytes)
                .int8(0)             # isolation level: read uncommitted
                .array([None], lambda w, _: (
                    w.string(topic),
                    w.array(partitions, lambda w2, p: (
                        w2.int32(p),
                        w2.int64(offsets[p]),
                        w2.int32(max_bytes),
                    )),
                ))
                .build()
            )
            reader = await self.node_connection(leader).call(
                proto.FETCH, 4, body,
                timeout=max(30.0, max_wait_ms / 1000 + 30),
            )
            reader.int32()  # throttle
            for _ in range(reader.int32()):
                reader.string()
                for _p in range(reader.int32()):
                    partition = reader.int32()
                    error = reader.int16()
                    high_watermark = reader.int64()
                    reader.int64()  # last stable offset
                    aborted = reader.int32()
                    for _a in range(max(0, aborted)):
                        reader.int64()
                        reader.int64()
                    record_set = reader.bytes_()
                    if error == proto.NONE:
                        out[partition] = (
                            proto.decode_record_batches(record_set or b""),
                            high_watermark,
                        )
                    elif error in proto.RETRIABLE:
                        await self.refresh_metadata([topic])
                        out[partition] = ([], high_watermark)
                    else:
                        raise KafkaProtocolError(
                            error, f"fetch {topic}/{partition}"
                        )

        for leader, partitions in by_leader.items():
            await fetch_from(leader, partitions)
        return out

    # -- list offsets (v1) -------------------------------------------------- #
    async def list_offset(
        self, topic: str, partition: int, timestamp: int
    ) -> int:
        """timestamp: -2 earliest, -1 latest → offset."""
        leader = await self.leader_for(topic, partition)
        body = (
            Writer()
            .int32(-1)
            .array([None], lambda w, _: (
                w.string(topic),
                w.array([None], lambda w2, _2: (
                    w2.int32(partition),
                    w2.int64(timestamp),
                )),
            ))
            .build()
        )
        reader = await self.node_connection(leader).call(
            proto.LIST_OFFSETS, 1, body
        )
        offset = -1
        for _ in range(reader.int32()):
            reader.string()
            for _p in range(reader.int32()):
                reader.int32()
                error = reader.int16()
                reader.int64()  # timestamp
                offset = reader.int64()
                if error != proto.NONE:
                    raise KafkaProtocolError(
                        error, f"list_offsets {topic}/{partition}"
                    )
        return offset

    # -- group coordination ------------------------------------------------- #
    async def find_coordinator(self, group_id: str) -> int:
        for attempt in range(10):
            body = Writer().string(group_id).build()
            reader = await self._bootstrap_connection().call(
                proto.FIND_COORDINATOR, 0, body
            )
            error = reader.int16()
            node_id = reader.int32()
            host = reader.string()
            port = reader.int32()
            if error == proto.NONE:
                self.brokers.setdefault(
                    node_id, BrokerInfo(node_id, host, port)
                )
                return node_id
            if error == proto.COORDINATOR_NOT_AVAILABLE:
                await asyncio.sleep(0.2 * (attempt + 1))
                continue
            raise KafkaProtocolError(error, f"find_coordinator {group_id}")
        raise KafkaProtocolError(
            proto.COORDINATOR_NOT_AVAILABLE, group_id
        )

    async def join_group(
        self, coordinator: int, group_id: str, member_id: str,
        topics: List[str], session_timeout_ms: int = 10000,
        rebalance_timeout_ms: int = 60000,
        conn: Optional[KafkaConnection] = None,
    ) -> Dict[str, Any]:
        body = (
            Writer()
            .string(group_id)
            .int32(session_timeout_ms)
            .int32(rebalance_timeout_ms)
            .string(member_id)
            .string("consumer")
            .array([None], lambda w, _: (
                w.string("range"),
                w.bytes_(proto.encode_subscription(topics)),
            ))
            .build()
        )
        reader = await (conn or self.node_connection(coordinator)).call(
            proto.JOIN_GROUP, 1, body, timeout=rebalance_timeout_ms / 1000 + 30
        )
        error = reader.int16()
        generation = reader.int32()
        protocol_name = reader.string()
        leader = reader.string()
        assigned_member = reader.string()
        members = []
        for _ in range(reader.int32()):
            mid = reader.string()
            metadata = reader.bytes_()
            members.append((mid, proto.decode_subscription(metadata or b"")))
        if error != proto.NONE:
            failure = KafkaProtocolError(error, f"join_group {group_id}")
            # KIP-394: the broker assigns a member id on the rejected
            # first join; surface it so the retry can present it
            failure.member_id = assigned_member
            raise failure
        return {
            "generation": generation,
            "protocol": protocol_name,
            "leader": leader,
            "member_id": assigned_member,
            "members": members,
        }

    async def sync_group(
        self, coordinator: int, group_id: str, generation: int,
        member_id: str,
        assignments: Optional[Dict[str, Dict[str, List[int]]]] = None,
        conn: Optional[KafkaConnection] = None,
    ) -> Dict[str, List[int]]:
        writer = (
            Writer()
            .string(group_id)
            .int32(generation)
            .string(member_id)
        )
        items = sorted((assignments or {}).items())
        writer.array(items, lambda w, item: (
            w.string(item[0]),
            w.bytes_(proto.encode_assignment(item[1])),
        ))
        reader = await (conn or self.node_connection(coordinator)).call(
            proto.SYNC_GROUP, 0, writer.build(), timeout=90
        )
        error = reader.int16()
        assignment = reader.bytes_()
        if error != proto.NONE:
            raise KafkaProtocolError(error, f"sync_group {group_id}")
        return proto.decode_assignment(assignment or b"")

    async def heartbeat(
        self, coordinator: int, group_id: str, generation: int,
        member_id: str, conn: Optional[KafkaConnection] = None,
    ) -> int:
        body = (
            Writer().string(group_id).int32(generation).string(member_id)
            .build()
        )
        reader = await (conn or self.node_connection(coordinator)).call(
            proto.HEARTBEAT, 0, body
        )
        return reader.int16()

    async def leave_group(
        self, coordinator: int, group_id: str, member_id: str,
        conn: Optional[KafkaConnection] = None,
    ) -> None:
        body = Writer().string(group_id).string(member_id).build()
        try:
            await (conn or self.node_connection(coordinator)).call(
                proto.LEAVE_GROUP, 0, body, timeout=5
            )
        except Exception:  # noqa: BLE001 — best effort on shutdown
            pass

    async def offset_commit(
        self, coordinator: int, group_id: str, generation: int,
        member_id: str, offsets: Dict[Tuple[str, int], int],
        conn: Optional[KafkaConnection] = None,
    ) -> None:
        by_topic: Dict[str, List[Tuple[int, int]]] = {}
        for (topic, partition), offset in offsets.items():
            by_topic.setdefault(topic, []).append((partition, offset))
        writer = (
            Writer()
            .string(group_id)
            .int32(generation)
            .string(member_id)
            .int64(-1)  # retention time: broker default
        )
        writer.array(sorted(by_topic.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, po: (
                w2.int32(po[0]),
                w2.int64(po[1]),
                w2.string(None),
            )),
        ))
        reader = await (conn or self.node_connection(coordinator)).call(
            proto.OFFSET_COMMIT, 2, writer.build()
        )
        for _ in range(reader.int32()):
            reader.string()
            for _p in range(reader.int32()):
                reader.int32()
                error = reader.int16()
                if error != proto.NONE:
                    raise KafkaProtocolError(
                        error, f"offset_commit {group_id}"
                    )

    async def offset_fetch(
        self, coordinator: int, group_id: str,
        partitions: List[Tuple[str, int]],
        conn: Optional[KafkaConnection] = None,
    ) -> Dict[Tuple[str, int], int]:
        by_topic: Dict[str, List[int]] = {}
        for topic, partition in partitions:
            by_topic.setdefault(topic, []).append(partition)
        writer = Writer().string(group_id)
        writer.array(sorted(by_topic.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, p: w2.int32(p)),
        ))
        reader = await (conn or self.node_connection(coordinator)).call(
            proto.OFFSET_FETCH, 1, writer.build()
        )
        out: Dict[Tuple[str, int], int] = {}
        for _ in range(reader.int32()):
            topic = reader.string()
            for _p in range(reader.int32()):
                partition = reader.int32()
                offset = reader.int64()
                reader.string()  # metadata
                error = reader.int16()
                if error == proto.NONE:
                    out[(topic, partition)] = offset
        return out

    # -- topic admin ---------------------------------------------------------- #
    async def create_topic(
        self, name: str, partitions: int, replication: int = 1,
        timeout_ms: int = 30000,
    ) -> None:
        await self.refresh_metadata([])
        controller = (
            self.controller_id
            if self.controller_id in self.brokers
            else next(iter(self.brokers), -1)
        )
        connection = (
            self.node_connection(controller)
            if controller >= 0 else self._bootstrap_connection()
        )
        body = (
            Writer()
            .array([None], lambda w, _: (
                w.string(name),
                w.int32(partitions),
                w.int16(replication),
                w.int32(0),   # manual assignments: none
                w.int32(0),   # configs: none
            ))
            .int32(timeout_ms)
            .build()
        )
        reader = await connection.call(proto.CREATE_TOPICS, 0, body)
        for _ in range(reader.int32()):
            reader.string()
            error = reader.int16()
            if error not in (proto.NONE, proto.TOPIC_ALREADY_EXISTS):
                raise KafkaProtocolError(error, f"create_topic {name}")
        await self.refresh_metadata([name])

    async def delete_topic(self, name: str, timeout_ms: int = 30000) -> None:
        await self.refresh_metadata([])
        controller = (
            self.controller_id
            if self.controller_id in self.brokers
            else next(iter(self.brokers), -1)
        )
        connection = (
            self.node_connection(controller)
            if controller >= 0 else self._bootstrap_connection()
        )
        body = (
            Writer()
            .array([name], lambda w, t: w.string(t))
            .int32(timeout_ms)
            .build()
        )
        reader = await connection.call(proto.DELETE_TOPICS, 0, body)
        for _ in range(reader.int32()):
            reader.string()
            error = reader.int16()
            if error not in (proto.NONE, proto.UNKNOWN_TOPIC_OR_PARTITION):
                raise KafkaProtocolError(error, f"delete_topic {name}")
        self.leaders.pop(name, None)

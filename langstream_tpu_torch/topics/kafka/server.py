"""Kafka-protocol broker facade: a single-node, in-process broker that
speaks the Kafka wire protocol (the same pinned API versions as
``client.py``).

Two jobs:

1. **Test target** for the client (the reference uses an embedded Kafka
   via testcontainers, ``AbstractApplicationRunner``); here the contract
   tests run the full group/produce/fetch/commit protocol over real TCP.
2. **Compatibility endpoint**: apps (or external Kafka tooling) can point
   at this broker with any Kafka client — the Redpanda idea in miniature,
   fronting this framework's in-process log.

Storage is in-memory per topic/partition; group coordination implements
the join/sync barrier with a bounded rebalance window.

The port's own copy of ``langstream_tpu/topics/kafka/server.py``; any
Kafka client talks to it, the JAX package's too.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
import uuid
from typing import Dict, List, Optional, Tuple

from langstream_tpu_torch.topics.kafka import protocol as proto
from langstream_tpu_torch.topics.kafka.protocol import Reader, Writer

logger = logging.getLogger(__name__)

# a rebalance waits for every previous member to rejoin (they notice via
# heartbeat) up to this deadline; members that miss it are evicted — the
# same role rebalance_timeout plays on a real broker
REBALANCE_DEADLINE = 10.0
FIRST_JOIN_WINDOW = 0.3  # batch-up window when the group was empty


class _Partition:
    __slots__ = ("records",)

    def __init__(self) -> None:
        # [(key, value, headers, timestamp)] — index == offset
        self.records: List[Tuple] = []


class _Group:
    def __init__(self) -> None:
        self.generation = 0
        self.members: Dict[str, bytes] = {}      # member id -> subscription
        self.leader: Optional[str] = None
        self.state = "Empty"                      # Empty|Rebalancing|Stable
        self.assignments: Dict[str, bytes] = {}
        self.offsets: Dict[Tuple[str, int], int] = {}
        self.join_barrier: Optional[asyncio.Event] = None
        self.sync_barrier: Optional[asyncio.Event] = None
        self.pending: Dict[str, bytes] = {}
        # strong ref: the loop only weakly references tasks, and a
        # GC'd close_window would strand every joiner on the barrier
        self.window_task: Optional[asyncio.Task] = None


class KafkaFacadeBroker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.node_id = 0
        self.topics: Dict[str, List[_Partition]] = {}
        self.groups: Dict[str, _Group] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._lock = asyncio.Lock()

    # -- lifecycle ------------------------------------------------------ #
    async def start(self) -> "KafkaFacadeBroker":
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("kafka facade broker on %s:%d", self.host, self.port)
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def bootstrap(self) -> str:
        return f"{self.host}:{self.port}"

    def create_topic(self, name: str, partitions: int = 1) -> None:
        self.topics.setdefault(
            name, [_Partition() for _ in range(max(1, partitions))]
        )

    # -- connection loop ------------------------------------------------ #
    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    size_bytes = await reader.readexactly(4)
                except asyncio.IncompleteReadError:
                    return
                size = int.from_bytes(size_bytes, "big")
                payload = await reader.readexactly(size)
                request = Reader(payload)
                api_key = request.int16()
                api_version = request.int16()
                correlation_id = request.int32()
                request.string()  # client id
                try:
                    body = await self._dispatch(api_key, api_version, request)
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "facade handler failed (api %d v%d)",
                        api_key, api_version,
                    )
                    return
                response = struct.pack(">i", len(body) + 4) + struct.pack(
                    ">i", correlation_id
                ) + body
                writer.write(response)
                await writer.drain()
        finally:
            writer.close()

    async def _dispatch(self, api_key: int, version: int, req: Reader) -> bytes:
        handlers = {
            proto.API_VERSIONS: self._api_versions,
            proto.METADATA: self._metadata,
            proto.PRODUCE: self._produce,
            proto.FETCH: self._fetch,
            proto.LIST_OFFSETS: self._list_offsets,
            proto.CREATE_TOPICS: self._create_topics,
            proto.DELETE_TOPICS: self._delete_topics,
            proto.FIND_COORDINATOR: self._find_coordinator,
            proto.JOIN_GROUP: self._join_group,
            proto.SYNC_GROUP: self._sync_group,
            proto.HEARTBEAT: self._heartbeat,
            proto.LEAVE_GROUP: self._leave_group,
            proto.OFFSET_COMMIT: self._offset_commit,
            proto.OFFSET_FETCH: self._offset_fetch,
        }
        handler = handlers.get(api_key)
        if handler is None:
            raise ValueError(f"unsupported api key {api_key}")
        return await handler(req)

    # -- data-plane handlers -------------------------------------------- #
    async def _api_versions(self, req: Reader) -> bytes:
        writer = Writer().int16(proto.NONE)
        supported = [
            (proto.PRODUCE, 3, 3), (proto.FETCH, 4, 4),
            (proto.LIST_OFFSETS, 1, 1), (proto.METADATA, 1, 1),
            (proto.OFFSET_COMMIT, 2, 2), (proto.OFFSET_FETCH, 1, 1),
            (proto.FIND_COORDINATOR, 0, 0), (proto.JOIN_GROUP, 1, 1),
            (proto.HEARTBEAT, 0, 0), (proto.LEAVE_GROUP, 0, 0),
            (proto.SYNC_GROUP, 0, 0), (proto.API_VERSIONS, 0, 0),
            (proto.CREATE_TOPICS, 0, 0), (proto.DELETE_TOPICS, 0, 0),
        ]
        writer.array(supported, lambda w, row: (
            w.int16(row[0]), w.int16(row[1]), w.int16(row[2]),
        ))
        return writer.build()

    async def _metadata(self, req: Reader) -> bytes:
        count = req.int32()
        names = (
            sorted(self.topics)
            if count < 0
            else [req.string() for _ in range(count)]
        )
        writer = Writer()
        writer.array([self.node_id], lambda w, node: (
            w.int32(node), w.string(self.host), w.int32(self.port),
            w.string(None),
        ))
        writer.int32(self.node_id)  # controller
        rows = []
        for name in names:
            partitions = self.topics.get(name)
            rows.append((name, partitions))
        writer.array(rows, lambda w, row: self._metadata_topic(w, row))
        return writer.build()

    def _metadata_topic(self, writer: Writer, row) -> None:
        name, partitions = row
        if partitions is None:
            writer.int16(proto.UNKNOWN_TOPIC_OR_PARTITION)
            writer.string(name)
            writer.boolean(False)
            writer.int32(0)
            return
        writer.int16(proto.NONE)
        writer.string(name)
        writer.boolean(False)
        writer.array(list(range(len(partitions))), lambda w, p: (
            w.int16(proto.NONE), w.int32(p), w.int32(self.node_id),
            w.array([self.node_id], lambda w2, r: w2.int32(r)),
            w.array([self.node_id], lambda w2, r: w2.int32(r)),
        ))

    async def _produce(self, req: Reader) -> bytes:
        req.string()  # transactional id
        req.int16()   # acks
        req.int32()   # timeout
        results = []
        async with self._lock:
            for _ in range(req.int32()):
                topic = req.string()
                for _p in range(req.int32()):
                    partition_id = req.int32()
                    record_set = req.bytes_()
                    partitions = self.topics.get(topic)
                    if partitions is None or partition_id >= len(partitions):
                        results.append((
                            topic, partition_id,
                            proto.UNKNOWN_TOPIC_OR_PARTITION, -1,
                        ))
                        continue
                    partition = partitions[partition_id]
                    base = len(partition.records)
                    for record in proto.decode_record_batches(record_set or b""):
                        partition.records.append((
                            record.key, record.value, record.headers,
                            record.timestamp,
                        ))
                    results.append((topic, partition_id, proto.NONE, base))
        writer = Writer()
        by_topic: Dict[str, List[Tuple[int, int, int]]] = {}
        for topic, partition_id, error, base in results:
            by_topic.setdefault(topic, []).append((partition_id, error, base))
        writer.array(sorted(by_topic.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, row: (
                w2.int32(row[0]), w2.int16(row[1]), w2.int64(row[2]),
                w2.int64(-1),
            )),
        ))
        writer.int32(0)  # throttle
        return writer.build()

    async def _fetch(self, req: Reader) -> bytes:
        req.int32()  # replica
        max_wait_ms = req.int32()
        min_bytes = req.int32()
        req.int32()  # max bytes
        req.int8()   # isolation
        wants: List[Tuple[str, int, int]] = []
        for _ in range(req.int32()):
            topic = req.string()
            for _p in range(req.int32()):
                partition_id = req.int32()
                offset = req.int64()
                req.int32()
                wants.append((topic, partition_id, offset))

        def collect():
            out = []
            total = 0
            for topic, partition_id, offset in wants:
                partitions = self.topics.get(topic)
                if partitions is None or partition_id >= len(partitions):
                    out.append((topic, partition_id,
                                proto.UNKNOWN_TOPIC_OR_PARTITION, 0, b""))
                    continue
                records = partitions[partition_id].records
                high_watermark = len(records)
                chunk = records[offset:offset + 500]
                encoded = b""
                if chunk:
                    encoded = proto.encode_record_batch(
                        [(k, v, h, ts) for (k, v, h, ts) in chunk],
                        base_offset=offset,
                    )
                    total += len(encoded)
                out.append((topic, partition_id, proto.NONE,
                            high_watermark, encoded))
            return out, total

        deadline = time.monotonic() + max_wait_ms / 1000.0
        while True:
            results, total = collect()
            if total >= max(1, min_bytes) or time.monotonic() >= deadline:
                break
            await asyncio.sleep(0.02)

        writer = Writer().int32(0)  # throttle
        by_topic: Dict[str, List[Tuple]] = {}
        for topic, partition_id, error, hw, encoded in results:
            by_topic.setdefault(topic, []).append(
                (partition_id, error, hw, encoded)
            )
        writer.array(sorted(by_topic.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, row: (
                w2.int32(row[0]), w2.int16(row[1]), w2.int64(row[2]),
                w2.int64(row[2]),    # last stable offset
                w2.int32(0),         # aborted txns: empty
                w2.bytes_(row[3]),
            )),
        ))
        return writer.build()

    async def _list_offsets(self, req: Reader) -> bytes:
        req.int32()
        wants: List[Tuple[str, int, int]] = []
        for _ in range(req.int32()):
            topic = req.string()
            for _p in range(req.int32()):
                wants.append((topic, req.int32(), req.int64()))
        writer = Writer()
        by_topic: Dict[str, List[Tuple[int, int]]] = {}
        for topic, partition_id, timestamp in wants:
            partitions = self.topics.get(topic, [])
            end = (
                len(partitions[partition_id].records)
                if partition_id < len(partitions) else 0
            )
            offset = 0 if timestamp == -2 else end
            by_topic.setdefault(topic, []).append((partition_id, offset))
        writer.array(sorted(by_topic.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, row: (
                w2.int32(row[0]), w2.int16(proto.NONE), w2.int64(-1),
                w2.int64(row[1]),
            )),
        ))
        return writer.build()

    async def _create_topics(self, req: Reader) -> bytes:
        created: List[Tuple[str, int]] = []
        for _ in range(req.int32()):
            name = req.string()
            partitions = req.int32()
            req.int16()  # replication
            for _a in range(max(0, req.int32())):
                req.int32()
                req.array(lambda r: r.int32())
            for _c in range(max(0, req.int32())):
                req.string()
                req.string()
            if name in self.topics:
                created.append((name, proto.TOPIC_ALREADY_EXISTS))
            else:
                self.create_topic(name, partitions if partitions > 0 else 1)
                created.append((name, proto.NONE))
        req.int32()  # timeout
        writer = Writer()
        writer.array(created, lambda w, row: (
            w.string(row[0]), w.int16(row[1]),
        ))
        return writer.build()

    async def _delete_topics(self, req: Reader) -> bytes:
        names = req.array(lambda r: r.string())
        req.int32()
        writer = Writer()
        results = []
        for name in names:
            if self.topics.pop(name, None) is None:
                results.append((name, proto.UNKNOWN_TOPIC_OR_PARTITION))
            else:
                results.append((name, proto.NONE))
        writer.array(results, lambda w, row: (
            w.string(row[0]), w.int16(row[1]),
        ))
        return writer.build()

    # -- group handlers -------------------------------------------------- #
    async def _find_coordinator(self, req: Reader) -> bytes:
        req.string()
        return (
            Writer().int16(proto.NONE).int32(self.node_id)
            .string(self.host).int32(self.port).build()
        )

    async def _join_group(self, req: Reader) -> bytes:
        group_id = req.string()
        req.int32()  # session timeout
        req.int32()  # rebalance timeout
        member_id = req.string() or f"member-{uuid.uuid4().hex[:12]}"
        req.string()  # protocol type
        subscription = b""
        for _ in range(req.int32()):
            req.string()  # protocol name ("range")
            subscription = req.bytes_() or b""
        group = self.groups.setdefault(group_id, _Group())
        # enter the rebalance: collect joiners within the window
        if group.state != "Rebalancing":
            group.state = "Rebalancing"
            group.pending = {}
            group.join_barrier = asyncio.Event()
            group.sync_barrier = asyncio.Event()
            group.assignments = {}

            async def close_window(g: _Group, expected: set) -> None:
                if expected:
                    deadline = time.monotonic() + REBALANCE_DEADLINE
                    while time.monotonic() < deadline:
                        if expected <= set(g.pending):
                            break
                        await asyncio.sleep(0.01)
                else:
                    # empty group: short window so a burst of first
                    # joiners lands in one generation
                    await asyncio.sleep(FIRST_JOIN_WINDOW)
                g.generation += 1
                g.members = dict(g.pending)
                g.leader = sorted(g.members)[0] if g.members else None
                g.join_barrier.set()

            group.window_task = asyncio.get_running_loop().create_task(
                close_window(group, set(group.members))
            )
        group.pending[member_id] = subscription
        await group.join_barrier.wait()
        if member_id not in group.members:
            # joined after the window closed: next generation
            return await self._rejoin_next(group, group_id, member_id,
                                           subscription)
        writer = (
            Writer()
            .int16(proto.NONE)
            .int32(group.generation)
            .string("range")
            .string(group.leader)
            .string(member_id)
        )
        members = (
            sorted(group.members.items()) if member_id == group.leader else []
        )
        writer.array(members, lambda w, item: (
            w.string(item[0]), w.bytes_(item[1]),
        ))
        return writer.build()

    async def _rejoin_next(
        self, group: _Group, group_id: str, member_id: str, subscription: bytes
    ) -> bytes:
        return (
            Writer().int16(proto.REBALANCE_IN_PROGRESS).int32(-1)
            .string("").string("").string(member_id).int32(0).build()
        )

    async def _sync_group(self, req: Reader) -> bytes:
        group_id = req.string()
        generation = req.int32()
        member_id = req.string()
        assignments = []
        for _ in range(req.int32()):
            assignments.append((req.string(), req.bytes_() or b""))
        group = self.groups.get(group_id)
        if group is None or generation != group.generation:
            return (
                Writer().int16(proto.ILLEGAL_GENERATION).bytes_(b"").build()
            )
        if member_id == group.leader:
            group.assignments = dict(assignments)
            group.state = "Stable"
            group.sync_barrier.set()
        try:
            # bounded: a leader that died between join and sync must not
            # hang every follower — they get REBALANCE_IN_PROGRESS and
            # rejoin (which elects a live leader)
            await asyncio.wait_for(
                group.sync_barrier.wait(), REBALANCE_DEADLINE
            )
        except asyncio.TimeoutError:
            group.members.pop(group.leader, None)
            group.state = "PendingRebalance"
            return (
                Writer().int16(proto.REBALANCE_IN_PROGRESS)
                .bytes_(b"").build()
            )
        return (
            Writer().int16(proto.NONE)
            .bytes_(group.assignments.get(member_id, b"")).build()
        )

    async def _heartbeat(self, req: Reader) -> bytes:
        group_id = req.string()
        generation = req.int32()
        member_id = req.string()
        group = self.groups.get(group_id)
        if group is None or member_id not in group.members:
            return Writer().int16(proto.UNKNOWN_MEMBER_ID).build()
        if group.state in ("Rebalancing", "PendingRebalance"):
            return Writer().int16(proto.REBALANCE_IN_PROGRESS).build()
        if generation != group.generation:
            return Writer().int16(proto.ILLEGAL_GENERATION).build()
        return Writer().int16(proto.NONE).build()

    async def _leave_group(self, req: Reader) -> bytes:
        group_id = req.string()
        member_id = req.string()
        group = self.groups.get(group_id)
        if group is not None:
            group.members.pop(member_id, None)
            group.pending.pop(member_id, None)
            # survivors must rebalance to take over the partitions
            if group.members and group.state == "Stable":
                group.state = "PendingRebalance"
        return Writer().int16(proto.NONE).build()

    async def _offset_commit(self, req: Reader) -> bytes:
        group_id = req.string()
        req.int32()   # generation (trusted in the facade)
        req.string()  # member
        req.int64()   # retention
        group = self.groups.setdefault(group_id, _Group())
        results: Dict[str, List[Tuple[int, int]]] = {}
        for _ in range(req.int32()):
            topic = req.string()
            for _p in range(req.int32()):
                partition_id = req.int32()
                offset = req.int64()
                req.string()
                group.offsets[(topic, partition_id)] = offset
                results.setdefault(topic, []).append(
                    (partition_id, proto.NONE)
                )
        writer = Writer()
        writer.array(sorted(results.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, row: (
                w2.int32(row[0]), w2.int16(row[1]),
            )),
        ))
        return writer.build()

    async def _offset_fetch(self, req: Reader) -> bytes:
        group_id = req.string()
        group = self.groups.setdefault(group_id, _Group())
        wants: Dict[str, List[int]] = {}
        for _ in range(req.int32()):
            topic = req.string()
            wants[topic] = req.array(lambda r: r.int32())
        writer = Writer()
        writer.array(sorted(wants.items()), lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, partition_id: (
                w2.int32(partition_id),
                w2.int64(group.offsets.get((item[0], partition_id), -1)),
                w2.string(None),
                w2.int16(proto.NONE),
            )),
        ))
        return writer.build()


async def serve_kafka_facade(
    host: str = "127.0.0.1", port: int = 0
) -> KafkaFacadeBroker:
    return await KafkaFacadeBroker(host, port).start()


async def _serve_forever(host: str, port: int) -> None:
    broker = await serve_kafka_facade(host, port)
    print(f"kafka facade broker on {broker.bootstrap}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await broker.close()


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m langstream_tpu_torch.topics.kafka.server [--host H]
    [--port P]``: serve the facade broker until SIGINT or SIGTERM; it
    prints ``kafka facade broker on HOST:PORT`` once it listens (port 0
    picks a free one)."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(description="serve the Kafka-protocol facade broker")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9092)
    args = parser.parse_args(argv)
    def stop(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    try:
        asyncio.run(_serve_forever(args.host, args.port))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

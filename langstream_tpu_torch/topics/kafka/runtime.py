"""Kafka implementation of the Topic SPI.

Reference: ``KafkaTopicConnectionsRuntime.java:53`` (producer/consumer/
reader/admin factories) and ``KafkaConsumerWrapper.java:52-230`` — the
out-of-order ack bookkeeping is reproduced here: every delivered offset
is tracked, acks land in a per-partition set, and the *committed* offset
only advances across the contiguous prefix, so a crash never skips an
in-flight record (at-least-once).

Serialization: values/keys/headers use a typed envelope in one Kafka
header (``ls-meta``) so Python payloads (str/bytes/dict/...) round-trip;
foreign records (no envelope) decode as UTF-8 text, falling back to raw
bytes — the same contract the reference gets from configurable Kafka
serializers.

The port's own copy of ``langstream_tpu/topics/kafka/runtime.py``: the
same envelope, so either package reads the other's records.
"""

from __future__ import annotations

import asyncio
import json
import logging
import zlib
from typing import Any, Dict, List, Optional, Tuple

from langstream_tpu_torch.api.records import Record, now_millis
from langstream_tpu_torch.api.topics import (
    OffsetPosition,
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConsumer,
    TopicProducer,
    TopicReader,
    TopicSpec,
)
from langstream_tpu_torch.topics.kafka import avro as avro_codec
from langstream_tpu_torch.topics.kafka import protocol as proto
from langstream_tpu_torch.topics.kafka.client import KafkaClient

logger = logging.getLogger(__name__)

EARLIEST, LATEST = -2, -1


# ---------------------------------------------------------------------- #
# record (de)serialization (shared envelope: topics/serde.py)
# ---------------------------------------------------------------------- #
from langstream_tpu_torch.topics.serde import (  # noqa: E402
    decode_payload as _decode_payload,
    encode_payload as _encode_payload,
)


def encode_record(record: Record) -> Tuple[
    Optional[bytes], Optional[bytes], List[Tuple[str, Optional[bytes]]]
]:
    key, key_kind = _encode_payload(record.key)
    value, value_kind = _encode_payload(record.value)
    headers: List[Tuple[str, Optional[bytes]]] = []
    header_kinds: Dict[str, str] = {}
    for name, hvalue in record.headers:
        data, kind = _encode_payload(hvalue)
        headers.append((name, data))
        header_kinds[name] = kind
    meta = json.dumps({"v": value_kind, "k": key_kind, "h": header_kinds})
    headers.append(("ls-meta", meta.encode("utf-8")))
    return key, value, headers


def decode_record(
    kafka_record: proto.KafkaRecord, topic: str
) -> "KafkaRecordView":
    kinds: Dict[str, Any] = {}
    headers: List[Tuple[str, Any]] = []
    raw_headers = []
    for name, data in kafka_record.headers:
        if name == "ls-meta" and data is not None:
            try:
                kinds = json.loads(data.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                kinds = {}
        else:
            raw_headers.append((name, data))
    header_kinds = kinds.get("h", {})
    for name, data in raw_headers:
        headers.append((name, _decode_payload(data, header_kinds.get(name))))
    return KafkaRecordView(
        value=_decode_payload(kafka_record.value, kinds.get("v")),
        key=_decode_payload(kafka_record.key, kinds.get("k")),
        origin=topic,
        timestamp=kafka_record.timestamp,
        headers=tuple(headers),
        partition=-1,  # caller fills in
        offset=kafka_record.offset,
    )


import dataclasses as _dataclasses


@_dataclasses.dataclass(frozen=True)
class KafkaRecordView(Record):
    """A Record plus its Kafka coordinates (what commit() needs)."""

    partition: int = -1
    offset: int = -1




async def _maybe_avro(registry, kafka_record, view):
    """Decode a FOREIGN Confluent-framed Avro value into plain Python
    (records produced by this framework carry the ls-meta envelope and
    are never reinterpreted)."""
    if registry is None:
        return view
    if any(name == "ls-meta" for name, _ in kafka_record.headers):
        return view
    if not avro_codec.is_confluent_framed(kafka_record.value):
        return view
    try:
        value = await registry.decode_value(kafka_record.value)
    except Exception:  # noqa: BLE001 — undecodable: keep raw bytes
        logger.exception("confluent avro decode failed; passing raw bytes")
        return view
    return _dataclasses.replace(view, value=value)


# ---------------------------------------------------------------------- #
# producer
# ---------------------------------------------------------------------- #
class KafkaTopicProducer(TopicProducer):
    """Micro-batching producer: concurrent ``write()``s within the linger
    window coalesce into one record batch per partition (the reference
    relies on the Kafka client's linger.ms/batch.size for the same);
    every ``write()`` still awaits its own batch's broker ack, so the
    durability contract (await = acked) is unchanged."""

    def __init__(
        self, client: KafkaClient, topic: str,
        *, linger: float = 0.002, batch_max: int = 256,
        value_schema: Optional[Any] = None,
        registry: Optional[avro_codec.SchemaRegistryClient] = None,
        subject: Optional[str] = None,
    ) -> None:
        self._client = client
        self._topic = topic
        self._linger = linger
        self._batch_max = batch_max
        # declared avro topic schema + registry → publish Confluent-
        # framed values foreign consumers understand (no ls-meta
        # envelope); lazily registered under <topic>-value
        self._value_schema = value_schema
        self._registry = registry
        self._subject = subject or f"{topic}-value"
        self._schema_id: Optional[int] = None
        # plain schema types publish WITHOUT the envelope: string/json/
        # bytes values any foreign consumer reads directly
        self._plain_type: Optional[str] = None
        self._written = 0
        self._round_robin = 0
        # partition -> [((key, value, headers, ts), future)]
        self._buffers: Dict[int, List] = {}
        self._flush_tasks: Dict[int, asyncio.Task] = {}

    @property
    def topic(self) -> str:
        return self._topic

    async def start(self) -> None:
        await self._client.partitions_for(self._topic)

    async def write(self, record: Record) -> None:
        partitions = await self._client.partitions_for(self._topic)
        if not partitions:
            raise proto.KafkaProtocolError(
                proto.UNKNOWN_TOPIC_OR_PARTITION, self._topic
            )
        if self._plain_type is not None:
            if self._plain_type == "string":
                value = (
                    record.value.encode("utf-8")
                    if isinstance(record.value, str)
                    else json.dumps(record.value).encode("utf-8")
                )
            elif self._plain_type == "json":
                value = json.dumps(record.value).encode("utf-8")
            else:  # bytes
                value = (
                    record.value
                    if isinstance(record.value, (bytes, bytearray))
                    else str(record.value).encode("utf-8")
                )
            key = (
                str(record.key).encode("utf-8")
                if record.key is not None else None
            )
            headers = []
            for name, hvalue in record.headers:
                data, _kind = _encode_payload(hvalue)
                headers.append((name, data))
        elif self._value_schema is not None and self._registry is not None:
            if self._schema_id is None:
                self._schema_id = await self._registry.register(
                    self._subject, self._value_schema
                )
            value = avro_codec.encode_confluent(
                self._schema_id, self._value_schema, record.value
            )
            key = (
                str(record.key).encode("utf-8")
                if record.key is not None else None
            )
            headers = []
            for name, hvalue in record.headers:
                data, _kind = _encode_payload(hvalue)
                headers.append((name, data))
        else:
            key, value, headers = encode_record(record)
        if record.key is not None:
            # stable key → partition affinity (session/KV locality rides
            # partitioning, like the reference's keyed producer). crc32 is
            # process-stable — Python's hash() is salted per interpreter
            index = zlib.crc32(str(record.key).encode("utf-8")) % len(
                partitions
            )
        else:
            index = self._round_robin % len(partitions)
            self._round_robin += 1
        partition = partitions[index]
        timestamp = record.timestamp or now_millis()
        future = asyncio.get_running_loop().create_future()
        rows = self._buffers.setdefault(partition, [])
        rows.append(((key, value, headers, timestamp), future))
        if len(rows) >= self._batch_max:
            await self._flush(partition)
        elif partition not in self._flush_tasks:
            self._flush_tasks[partition] = (
                asyncio.get_running_loop().create_task(
                    self._flush_later(partition)
                )
            )
        await future
        self._written += 1

    async def _flush_later(self, partition: int) -> None:
        await asyncio.sleep(self._linger)
        await self._flush(partition)

    async def _flush(self, partition: int) -> None:
        task = self._flush_tasks.pop(partition, None)
        if task is not None and task is not asyncio.current_task():
            task.cancel()
        rows = self._buffers.pop(partition, [])
        if not rows:
            return
        batch = proto.encode_record_batch([payload for payload, _ in rows])
        try:
            await self._client.produce(self._topic, partition, batch)
        except BaseException as error:  # noqa: BLE001 — fail every waiter
            # the error travels via the futures (every write() awaits one);
            # not re-raised here so a timer-triggered flush doesn't also
            # log an unretrieved task exception
            for _, future in rows:
                if not future.done():
                    future.set_exception(error)
            return
        for _, future in rows:
            if not future.done():
                future.set_result(None)

    async def close(self) -> None:
        for partition in list(self._buffers):
            await self._flush(partition)
        for task in self._flush_tasks.values():
            task.cancel()
        self._flush_tasks.clear()

    def total_in(self) -> int:
        return self._written


# ---------------------------------------------------------------------- #
# consumer (group member, contiguous-watermark commit)
# ---------------------------------------------------------------------- #
class KafkaTopicConsumer(TopicConsumer):
    def __init__(
        self,
        client: KafkaClient,
        topic: str,
        group: str,
        *,
        session_timeout_ms: int = 10000,
        heartbeat_interval: float = 3.0,
        auto_offset_reset: int = EARLIEST,
        registry: Optional[avro_codec.SchemaRegistryClient] = None,
    ) -> None:
        self._client = client
        self._topic = topic
        self._group = group
        self._registry = registry
        self._session_timeout_ms = session_timeout_ms
        self._heartbeat_interval = heartbeat_interval
        self._auto_offset_reset = auto_offset_reset

        self._coordinator: int = -1
        self._member_id = ""
        self._generation = -1
        self._assignment: List[int] = []         # partitions of _topic
        self._fetch_pos: Dict[int, int] = {}     # next offset to fetch
        self._committed: Dict[int, int] = {}     # durable commit watermark
        # delivered-but-unacked offsets per partition, plus the offset
        # just past the last delivered record: the watermark is
        # min(outstanding) or, with nothing outstanding, next-after-
        # delivered. Using *delivered* offsets (not offset arithmetic)
        # keeps gaps — compaction, transaction markers — from stalling it
        self._outstanding: Dict[int, set] = {}
        self._next_after_delivered: Dict[int, int] = {}
        self._rejoin_needed = False
        self._coord_conn = None  # dedicated coordinator channel
        self._heartbeat_task: Optional[asyncio.Task] = None
        # serializes membership changes (join/rejoin) against read():
        # the heartbeat task rejoins PROMPTLY on a rebalance signal even
        # when the owner isn't polling (e.g. during app bring-up)
        self._membership_lock = asyncio.Lock()
        self._fetch_cursor = 0
        self._delivered = 0
        self._started = False
        # commit coalescing: watermark advances collect here and flush
        # to the coordinator at most every _commit_interval (plus on
        # close and before any rejoin) — the runner acks once per source
        # record, which would otherwise be one OffsetCommit RPC each
        self._commit_dirty: Dict[Tuple[str, int], int] = {}
        self._last_commit_flush = 0.0
        self._commit_interval = 0.1

    # -- membership ----------------------------------------------------- #
    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        async with self._membership_lock:
            await self._join()
        self._heartbeat_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop()
        )

    async def _reconnect_coordinator(self) -> None:
        if self._coord_conn is not None:
            await self._coord_conn.close()
        self._coordinator = await self._client.find_coordinator(self._group)
        self._coord_conn = self._client.dedicated_connection(self._coordinator)

    async def _join(self) -> None:
        # push pending watermark advances under the OLD generation first:
        # after the rebalance they would be rejected (ILLEGAL_GENERATION)
        # and the work they represent re-delivered unnecessarily
        try:
            await self._flush_commits_locked(force=True)
        except Exception:  # noqa: BLE001 — redelivery-safe to drop
            self._commit_dirty.clear()
        await self._reconnect_coordinator()
        for attempt in range(10):
            try:
                joined = await self._client.join_group(
                    self._coordinator, self._group, self._member_id,
                    [self._topic],
                    session_timeout_ms=self._session_timeout_ms,
                    conn=self._coord_conn,
                )
            except proto.KafkaProtocolError as error:
                if error.code == proto.MEMBER_ID_REQUIRED:
                    # KIP-394: adopt the broker-assigned id for the retry
                    self._member_id = getattr(error, "member_id", "") or ""
                    continue
                if error.code == proto.REBALANCE_IN_PROGRESS:
                    await asyncio.sleep(0.1)
                    continue
                if error.code in (
                    proto.NOT_COORDINATOR, proto.COORDINATOR_NOT_AVAILABLE,
                ):
                    await asyncio.sleep(0.2)
                    await self._reconnect_coordinator()
                    continue
                if error.code == proto.UNKNOWN_MEMBER_ID:
                    self._member_id = ""
                    continue
                raise
            self._member_id = joined["member_id"]
            self._generation = joined["generation"]
            assignments = None
            if joined["leader"] == self._member_id:
                partitions_by_topic: Dict[str, int] = {}
                for _mid, topics in joined["members"]:
                    for topic in topics:
                        partitions_by_topic[topic] = len(
                            await self._client.partitions_for(topic)
                        )
                assignments = proto.range_assign(
                    joined["members"], partitions_by_topic
                )
            try:
                my_assignment = await self._client.sync_group(
                    self._coordinator, self._group, self._generation,
                    self._member_id, assignments, conn=self._coord_conn,
                )
            except proto.KafkaProtocolError as error:
                if error.code in (
                    proto.REBALANCE_IN_PROGRESS, proto.ILLEGAL_GENERATION,
                ):
                    continue
                raise
            self._assignment = sorted(my_assignment.get(self._topic, []))
            await self._reset_positions()
            self._rejoin_needed = False
            logger.info(
                "kafka consumer %s joined %s gen %d: partitions %s",
                self._member_id, self._group, self._generation,
                self._assignment,
            )
            return
        raise proto.KafkaProtocolError(
            proto.REBALANCE_IN_PROGRESS, f"join retries exhausted {self._group}"
        )

    async def _reset_positions(self) -> None:
        """Start every assigned partition at the group's committed offset
        (or auto reset); uncommitted in-flight work from before a
        rebalance is redelivered — at-least-once."""
        self._fetch_pos.clear()
        self._committed.clear()
        self._outstanding = {p: set() for p in self._assignment}
        self._next_after_delivered = {}
        if not self._assignment:
            return
        committed = await self._client.offset_fetch(
            self._coordinator, self._group,
            [(self._topic, p) for p in self._assignment],
            conn=self._coord_conn,
        )
        for partition in self._assignment:
            offset = committed.get((self._topic, partition), -1)
            if offset < 0:
                offset = await self._client.list_offset(
                    self._topic, partition, self._auto_offset_reset
                )
            self._fetch_pos[partition] = offset
            self._committed[partition] = offset
            self._next_after_delivered[partition] = offset

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self._heartbeat_interval)
            try:
                # the lock covers the heartbeat AND any rejoin it
                # triggers: membership state (generation, member id,
                # coordinator connection) is only ever read or mutated
                # under the lock, so a heartbeat can't carry a stale
                # generation from a half-finished join and a rejoin can't
                # close the coordinator connection under an in-flight
                # commit (read()/commit() hold the same lock)
                async with self._membership_lock:
                    code = await self._client.heartbeat(
                        self._coordinator, self._group, self._generation,
                        self._member_id, conn=self._coord_conn,
                    )
                    if code in (
                        proto.REBALANCE_IN_PROGRESS,
                        proto.ILLEGAL_GENERATION,
                        proto.UNKNOWN_MEMBER_ID, proto.NOT_COORDINATOR,
                    ):
                        # rejoin NOW (not at the next poll): other
                        # members' rebalance windows wait for this
                        # member, and the owner may not be polling yet
                        if self._member_id:
                            self._generation = -1
                        await self._join()
                        self._rejoin_needed = False
            except Exception:  # noqa: BLE001 — transient; retry next beat
                continue

    # -- data ------------------------------------------------------------ #
    async def read(
        self, max_records: int = 100, timeout: float = 0.1
    ) -> List[Record]:
        if not self._started:
            await self.start()
        # the WHOLE poll body runs under the membership lock: the
        # heartbeat task's rejoin can then only interleave BETWEEN
        # polls, never against an in-flight fetch whose positions a
        # _reset_positions() would invalidate
        async with self._membership_lock:
            if self._rejoin_needed:
                if self._member_id:
                    self._generation = -1
                await self._join()
            if not self._assignment:
                pause = timeout
            else:
                pause = 0.0
                out: List[Record] = []
                # ONE fetch covering every assigned partition: idle
                # partitions share a single long-poll instead of
                # serializing P timeouts
                results = await self._client.fetch_multi(
                    self._topic,
                    {p: self._fetch_pos[p] for p in self._assignment},
                    max_wait_ms=int(timeout * 1000),
                )
                # rotate the partition order so no partition starves
                # when max_records truncates the batch
                order = (
                    self._assignment[self._fetch_cursor:]
                    + self._assignment[:self._fetch_cursor]
                )
                self._fetch_cursor = (
                    self._fetch_cursor + 1
                ) % len(self._assignment)
                for partition in order:
                    records, _hw = results.get(partition, ([], -1))
                    for kafka_record in records:
                        if kafka_record.offset < self._fetch_pos[partition]:
                            continue  # batch replay below requested offset
                        if len(out) >= max_records:
                            break
                        view = decode_record(kafka_record, self._topic)
                        view = _dataclasses.replace(
                            view, partition=partition
                        )
                        view = await _maybe_avro(
                            self._registry, kafka_record, view
                        )
                        out.append(view)
                        self._fetch_pos[partition] = kafka_record.offset + 1
                        self._outstanding.setdefault(partition, set()).add(
                            kafka_record.offset
                        )
                        self._next_after_delivered[partition] = (
                            kafka_record.offset + 1
                        )
                self._delivered += len(out)
                return out
        # empty assignment: idle OUTSIDE the lock so heartbeats flow
        await asyncio.sleep(pause)
        return []

    async def commit(self, records: List[Record]) -> None:
        """Out-of-order acks allowed; durable offset = contiguous prefix
        (KafkaConsumerWrapper.java:52-230 semantics). The RPC itself is
        coalesced onto a short timer."""
        async with self._membership_lock:
            await self._commit_locked(records, self._commit_dirty)
            await self._flush_commits_locked()

    async def _flush_commits_locked(self, force: bool = False) -> None:
        import time as _time

        if not self._commit_dirty:
            return
        now = _time.monotonic()
        if not force and now - self._last_commit_flush < self._commit_interval:
            return
        if self._generation < 0:
            return
        dirty, self._commit_dirty = self._commit_dirty, {}
        self._last_commit_flush = now
        await self._client.offset_commit(
            self._coordinator, self._group, self._generation,
            self._member_id, dirty, conn=self._coord_conn,
        )

    async def _commit_locked(self, records, to_commit) -> None:
        for record in records:
            if not isinstance(record, KafkaRecordView):
                raise ValueError(
                    f"cannot commit a non-kafka record: {record!r}"
                )
            if record.partition not in self._outstanding:
                # partition reassigned away mid-flight: the new owner's
                # watermark is authoritative; committing here would
                # regress the group offset
                logger.info(
                    "dropping stale ack for %s/%d (not assigned)",
                    self._topic, record.partition,
                )
                continue
            outstanding = self._outstanding[record.partition]
            outstanding.discard(record.offset)
            watermark = (
                min(outstanding)
                if outstanding
                else self._next_after_delivered.get(record.partition, 0)
            )
            if watermark > self._committed.get(record.partition, -1):
                self._committed[record.partition] = watermark
                to_commit[(self._topic, record.partition)] = watermark
        # RPC handled by _flush_commits_locked (coalesced)

    def committed_offsets(self) -> Dict[int, int]:
        return dict(self._committed)

    async def close(self) -> None:
        async with self._membership_lock:
            try:
                await self._flush_commits_locked(force=True)
            except Exception:  # noqa: BLE001 — at-least-once: safe
                pass
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            try:
                await self._heartbeat_task
            except asyncio.CancelledError:
                pass
            self._heartbeat_task = None
        if self._member_id and self._coordinator >= 0:
            await self._client.leave_group(
                self._coordinator, self._group, self._member_id,
                conn=self._coord_conn,
            )
        if self._coord_conn is not None:
            await self._coord_conn.close()
            self._coord_conn = None
        self._started = False

    def total_out(self) -> int:
        return self._delivered


# ---------------------------------------------------------------------- #
# reader (group-less tail)
# ---------------------------------------------------------------------- #
class KafkaTopicReader(TopicReader):
    def __init__(
        self, client: KafkaClient, topic: str, position: OffsetPosition,
        registry: Optional[avro_codec.SchemaRegistryClient] = None,
    ) -> None:
        self._client = client
        self._topic = topic
        self._position = position
        self._registry = registry
        self._offsets: Dict[int, int] = {}

    async def start(self) -> None:
        timestamp = (
            EARLIEST if self._position == OffsetPosition.EARLIEST else LATEST
        )
        for partition in await self._client.partitions_for(self._topic):
            self._offsets[partition] = await self._client.list_offset(
                self._topic, partition, timestamp
            )

    async def read(
        self, max_records: int = 100, timeout: float = 0.1
    ) -> List[Record]:
        if not self._offsets:
            await self.start()
        out: List[Record] = []
        results = await self._client.fetch_multi(
            self._topic, dict(self._offsets),
            max_wait_ms=int(timeout * 1000),
        )
        for partition, (records, _hw) in results.items():
            for kafka_record in records:
                if kafka_record.offset < self._offsets[partition]:
                    continue
                if len(out) >= max_records:
                    return out
                view = decode_record(kafka_record, self._topic)
                view = _dataclasses.replace(view, partition=partition)
                view = await _maybe_avro(
                    self._registry, kafka_record, view
                )
                out.append(view)
                self._offsets[partition] = kafka_record.offset + 1
        return out


# ---------------------------------------------------------------------- #
# admin + runtime
# ---------------------------------------------------------------------- #
class KafkaTopicAdmin(TopicAdmin):
    def __init__(self, client: KafkaClient, replication: int = 1) -> None:
        self._client = client
        self._replication = replication

    async def create_topic(self, spec: TopicSpec) -> None:
        await self._client.create_topic(
            spec.name, max(1, spec.partitions), self._replication
        )

    async def delete_topic(self, name: str) -> None:
        await self._client.delete_topic(name)


class KafkaTopicConnectionsRuntime(TopicConnectionsRuntime):
    """``streamingCluster: {type: kafka, configuration: {bootstrapServers:
    host:port, ...}}`` (the reference accepts ``admin.bootstrap.servers``
    too — both spellings are honored here)."""

    def __init__(self, configuration: Optional[Dict[str, Any]] = None) -> None:
        configuration = configuration or {}
        admin = configuration.get("admin") or {}
        bootstrap = (
            configuration.get("bootstrapServers")
            or configuration.get("bootstrap_servers")
            or configuration.get("bootstrap.servers")
            or admin.get("bootstrap.servers")
            or admin.get("bootstrapServers")
            or "127.0.0.1:9092"
        )
        self.configuration = configuration
        self._client = KafkaClient(
            bootstrap,
            client_id=configuration.get("clientId", "langstream-tpu"),
            # ApiVersions handshake on every new connection (KIP-896
            # guard); `verifyApiVersions: false` opts out for brokers
            # that firewall the API
            verify_versions=bool(
                configuration.get("verifyApiVersions", True)
            ),
        )
        self._replication = int(configuration.get("replicationFactor", 1))
        registry_url = (
            configuration.get("schemaRegistryUrl")
            or configuration.get("schema.registry.url")
        )
        # foreign Confluent-Avro records decode into plain dict values
        # (the reference's schema-registry deserializer path)
        self._registry = (
            avro_codec.SchemaRegistryClient(registry_url)
            if registry_url else None
        )

    def create_consumer(
        self, agent_id: str, config: Dict[str, Any]
    ) -> TopicConsumer:
        return KafkaTopicConsumer(
            self._client,
            config["topic"],
            config.get("group") or f"langstream-{agent_id}",
            session_timeout_ms=int(
                self.configuration.get("sessionTimeoutMs", 10000)
            ),
            auto_offset_reset=(
                LATEST
                if self.configuration.get("autoOffsetReset") == "latest"
                else EARLIEST
            ),
            registry=self._registry,
        )

    def create_producer(
        self, agent_id: str, config: Dict[str, Any]
    ) -> TopicProducer:
        value_schema = None
        schema_config = config.get("schema") or {}
        schema_type = str(schema_config.get("type", "")).lower()
        if (
            self._registry is not None
            and schema_type == "avro"
            and schema_config.get("schema")
        ):
            value_schema = avro_codec.parse_schema(schema_config["schema"])
        producer = KafkaTopicProducer(
            self._client, config["topic"],
            value_schema=value_schema, registry=self._registry,
        )
        if schema_type in ("string", "json", "bytes"):
            producer._plain_type = schema_type  # noqa: SLF001
        return producer

    def create_reader(
        self,
        config: Dict[str, Any],
        initial_position: OffsetPosition = OffsetPosition.LATEST,
    ) -> TopicReader:
        return KafkaTopicReader(
            self._client, config["topic"], initial_position,
            registry=self._registry,
        )

    def create_admin(self) -> TopicAdmin:
        return KafkaTopicAdmin(self._client, self._replication)

    async def close(self) -> None:
        if self._registry is not None:
            await self._registry.close()
        await self._client.close()

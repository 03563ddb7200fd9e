"""Kafka wire protocol: primitives, message codecs, record batches v2.

Implemented from the public protocol specification (kafka.apache.org/
protocol). Non-flexible (pre-KIP-482) API versions are used throughout so
no tagged-field plumbing is needed; every schema below is pinned to one
version:

=================  =====  ===
API                key    ver
=================  =====  ===
Produce            0      3
Fetch              1      4
ListOffsets        2      1
Metadata           3      1
OffsetCommit       8      2
OffsetFetch        9      1
FindCoordinator    10     0
JoinGroup          11     1
Heartbeat          12     0
LeaveGroup         13     0
SyncGroup          14     0
ApiVersions        18     0
CreateTopics       19     0
DeleteTopics       20     0
=================  =====  ===

Record batches are magic-v2 (the only format v3+ Produce accepts):
varint-encoded records guarded by a CRC32C over the batch payload.

The port's own copy of ``langstream_tpu/topics/kafka/protocol.py``: the
same bytes on the wire; its CRC32C runs only on the native library.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------- #
# api keys + error codes
# ---------------------------------------------------------------------- #
PRODUCE, FETCH, LIST_OFFSETS, METADATA = 0, 1, 2, 3
OFFSET_COMMIT, OFFSET_FETCH, FIND_COORDINATOR = 8, 9, 10
JOIN_GROUP, HEARTBEAT, LEAVE_GROUP, SYNC_GROUP = 11, 12, 13, 14
API_VERSIONS, CREATE_TOPICS, DELETE_TOPICS = 18, 19, 20

NONE = 0
UNKNOWN_TOPIC_OR_PARTITION = 3
NOT_LEADER_FOR_PARTITION = 6
COORDINATOR_NOT_AVAILABLE = 15
NOT_COORDINATOR = 16
ILLEGAL_GENERATION = 22
UNKNOWN_MEMBER_ID = 25
REBALANCE_IN_PROGRESS = 27
TOPIC_ALREADY_EXISTS = 36
MEMBER_ID_REQUIRED = 79

RETRIABLE = {
    UNKNOWN_TOPIC_OR_PARTITION, NOT_LEADER_FOR_PARTITION,
    COORDINATOR_NOT_AVAILABLE, NOT_COORDINATOR, REBALANCE_IN_PROGRESS,
}

# every API version this client sends, in one place. The connection
# handshake verifies each against the broker's advertised [min, max]
# (ApiVersions), so "broker too new" (KIP-896: Kafka 4.0 removed
# pre-2.1 protocol versions) or "broker too old" fails at connect with
# a precise message instead of a mid-traffic decode error. ApiVersions
# itself is the bootstrap: brokers answer it at v0 regardless of their
# floor, exactly so old clients learn they are unsupported.
PINNED_VERSIONS: Dict[int, int] = {
    PRODUCE: 3, FETCH: 4, LIST_OFFSETS: 1, METADATA: 1,
    OFFSET_COMMIT: 2, OFFSET_FETCH: 1, FIND_COORDINATOR: 0,
    JOIN_GROUP: 1, HEARTBEAT: 0, LEAVE_GROUP: 0, SYNC_GROUP: 0,
    API_VERSIONS: 0, CREATE_TOPICS: 0, DELETE_TOPICS: 0,
}

API_NAMES: Dict[int, str] = {
    PRODUCE: "Produce", FETCH: "Fetch", LIST_OFFSETS: "ListOffsets",
    METADATA: "Metadata", OFFSET_COMMIT: "OffsetCommit",
    OFFSET_FETCH: "OffsetFetch", FIND_COORDINATOR: "FindCoordinator",
    JOIN_GROUP: "JoinGroup", HEARTBEAT: "Heartbeat",
    LEAVE_GROUP: "LeaveGroup", SYNC_GROUP: "SyncGroup",
    API_VERSIONS: "ApiVersions", CREATE_TOPICS: "CreateTopics",
    DELETE_TOPICS: "DeleteTopics",
}


def decode_api_versions(reader: "Reader") -> Dict[int, Tuple[int, int]]:
    """ApiVersions v0 response body → {api_key: (min, max)}. The
    leading error_code is returned under key -1 for the caller."""
    error_code = reader.int16()
    out: Dict[int, Tuple[int, int]] = {-1: (error_code, error_code)}
    for _ in range(reader.int32()):
        api_key = reader.int16()
        out[api_key] = (reader.int16(), reader.int16())
    return out


def unsupported_pinned_apis(
    advertised: Dict[int, Tuple[int, int]],
) -> List[str]:
    """Which pinned (api, version) pairs the broker does not serve."""
    problems: List[str] = []
    for api_key, version in sorted(PINNED_VERSIONS.items()):
        if api_key == API_VERSIONS:
            continue  # the handshake itself already round-tripped
        if api_key not in advertised:
            problems.append(f"{API_NAMES[api_key]} (not offered)")
            continue
        low, high = advertised[api_key]
        if not low <= version <= high:
            problems.append(
                f"{API_NAMES[api_key]} v{version} (broker serves "
                f"v{low}..v{high})"
            )
    return problems


class KafkaProtocolError(RuntimeError):
    def __init__(self, code: int, context: str = "") -> None:
        super().__init__(f"kafka error {code} {context}".strip())
        self.code = code


# ---------------------------------------------------------------------- #
# crc32c (Castagnoli, reflected poly 0x82F63B78) — required by batch v2
# ---------------------------------------------------------------------- #
def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c_python(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` on the native slice-by-8 library
    (``native/kafkacodec.cpp``), built on first use; a failed build
    raises. :func:`_crc32c_python` is the plain reference of the tests."""
    from langstream_tpu_torch import native

    return native.load("kafkacodec").ls_crc32c(data, len(data), crc)


# ---------------------------------------------------------------------- #
# primitive codecs
# ---------------------------------------------------------------------- #
class Writer:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def raw(self, data: bytes) -> "Writer":
        self._parts.append(data)
        return self

    def int8(self, v: int) -> "Writer":
        return self.raw(struct.pack(">b", v))

    def int16(self, v: int) -> "Writer":
        return self.raw(struct.pack(">h", v))

    def int32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">i", v))

    def int64(self, v: int) -> "Writer":
        return self.raw(struct.pack(">q", v))

    def uint32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">I", v))

    def boolean(self, v: bool) -> "Writer":
        return self.int8(1 if v else 0)

    def string(self, v: Optional[str]) -> "Writer":
        if v is None:
            return self.int16(-1)
        data = v.encode("utf-8")
        return self.int16(len(data)).raw(data)

    def bytes_(self, v: Optional[bytes]) -> "Writer":
        if v is None:
            return self.int32(-1)
        return self.int32(len(v)).raw(v)

    def varint(self, v: int) -> "Writer":
        """Zigzag-encoded signed varint."""
        return self.uvarint((v << 1) ^ (v >> 31))

    def varlong(self, v: int) -> "Writer":
        return self.uvarint((v << 1) ^ (v >> 63))

    def uvarint(self, v: int) -> "Writer":
        out = bytearray()
        while True:
            byte = v & 0x7F
            v >>= 7
            if v:
                out.append(byte | 0x80)
            else:
                out.append(byte)
                break
        return self.raw(bytes(out))

    def array(self, items: List[Any], encode) -> "Writer":
        self.int32(len(items))
        for item in items:
            encode(self, item)
        return self

    def build(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise EOFError(f"need {n} bytes at {self.pos}/{len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def int8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def uint32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def boolean(self) -> bool:
        return self.int8() != 0

    def string(self) -> Optional[str]:
        n = self.int16()
        return None if n < 0 else self._take(n).decode("utf-8")

    def bytes_(self) -> Optional[bytes]:
        n = self.int32()
        return None if n < 0 else self._take(n)

    def uvarint(self) -> int:
        shift = value = 0
        while True:
            byte = self._take(1)[0]
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7

    def varint(self) -> int:
        value = self.uvarint()
        return (value >> 1) ^ -(value & 1)

    varlong = varint

    def array(self, decode) -> List[Any]:
        n = self.int32()
        return [decode(self) for _ in range(max(0, n))]

    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------------- #
# request framing
# ---------------------------------------------------------------------- #
def encode_request(
    api_key: int, api_version: int, correlation_id: int,
    client_id: Optional[str], body: bytes,
) -> bytes:
    header = (
        Writer().int16(api_key).int16(api_version).int32(correlation_id)
        .string(client_id).build()
    )
    payload = header + body
    return struct.pack(">i", len(payload)) + payload


# ---------------------------------------------------------------------- #
# record batches (magic v2)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class KafkaRecord:
    offset: int
    timestamp: int
    key: Optional[bytes]
    value: Optional[bytes]
    headers: List[Tuple[str, Optional[bytes]]]


def encode_record_batch(
    records: List[Tuple[Optional[bytes], Optional[bytes],
                        List[Tuple[str, Optional[bytes]]], int]],
    base_offset: int = 0,
) -> bytes:
    """records: [(key, value, headers, timestamp_ms)] → one batch."""
    if not records:
        return b""
    base_timestamp = records[0][3]
    max_timestamp = max(r[3] for r in records)
    body = Writer()
    for i, (key, value, headers, timestamp) in enumerate(records):
        record = Writer()
        record.int8(0)  # attributes
        record.varlong(timestamp - base_timestamp)
        record.varint(i)  # offset delta
        if key is None:
            record.varint(-1)
        else:
            record.varint(len(key)).raw(key)
        if value is None:
            record.varint(-1)
        else:
            record.varint(len(value)).raw(value)
        record.varint(len(headers))
        for name, hvalue in headers:
            name_bytes = name.encode("utf-8")
            record.varint(len(name_bytes)).raw(name_bytes)
            if hvalue is None:
                record.varint(-1)
            else:
                record.varint(len(hvalue)).raw(hvalue)
        encoded = record.build()
        body.varint(len(encoded)).raw(encoded)

    # the crc covers attributes..records
    after_crc = (
        Writer()
        .int16(0)                      # attributes (no compression)
        .int32(len(records) - 1)       # last offset delta
        .int64(base_timestamp)
        .int64(max_timestamp)
        .int64(-1)                     # producer id
        .int16(-1)                     # producer epoch
        .int32(-1)                     # base sequence
        .int32(len(records))
        .raw(body.build())
        .build()
    )
    crc = crc32c(after_crc)
    batch_tail = (
        Writer()
        .int32(-1)                     # partition leader epoch
        .int8(2)                       # magic
        .uint32(crc)
        .raw(after_crc)
        .build()
    )
    return (
        Writer()
        .int64(base_offset)
        .int32(len(batch_tail))
        .raw(batch_tail)
        .build()
    )


def decode_record_batches(data: bytes) -> List[KafkaRecord]:
    """Parse a record set (possibly several concatenated batches; a
    truncated trailing batch — normal in Fetch responses — is skipped)."""
    out: List[KafkaRecord] = []
    reader = Reader(data)
    while reader.remaining() >= 12:
        base_offset = reader.int64()
        batch_length = reader.int32()
        if reader.remaining() < batch_length:
            break  # truncated tail
        batch = Reader(reader._take(batch_length))
        batch.int32()  # partition leader epoch
        magic = batch.int8()
        if magic != 2:
            continue  # legacy message sets unsupported (pre-0.11 brokers)
        batch.uint32()  # crc (trusted: TCP + broker already validated)
        attributes = batch.int16()
        if attributes & 0x20:
            # control batch (transaction commit/abort markers): consumes
            # offsets but carries no application records
            continue
        if attributes & 0x07:
            raise KafkaProtocolError(
                NONE, "compressed batches not supported (set "
                "compression.type=none / produce uncompressed)"
            )
        batch.int32()  # last offset delta
        base_timestamp = batch.int64()
        batch.int64()  # max timestamp
        batch.int64()  # producer id
        batch.int16()  # producer epoch
        batch.int32()  # base sequence
        count = batch.int32()
        for _ in range(count):
            length = batch.varint()
            record = Reader(batch._take(length))
            record.int8()  # attributes
            ts_delta = record.varlong()
            offset_delta = record.varint()
            key_len = record.varint()
            key = record._take(key_len) if key_len >= 0 else None
            value_len = record.varint()
            value = record._take(value_len) if value_len >= 0 else None
            headers: List[Tuple[str, Optional[bytes]]] = []
            for _h in range(record.varint()):
                name_len = record.varint()
                name = record._take(name_len).decode("utf-8")
                hlen = record.varint()
                hvalue = record._take(hlen) if hlen >= 0 else None
                headers.append((name, hvalue))
            out.append(KafkaRecord(
                offset=base_offset + offset_delta,
                timestamp=base_timestamp + ts_delta,
                key=key, value=value, headers=headers,
            ))
    return out


# ---------------------------------------------------------------------- #
# consumer-group protocol blobs (protocol type "consumer", strategy range)
# ---------------------------------------------------------------------- #
def encode_subscription(topics: List[str]) -> bytes:
    writer = Writer().int16(0)
    writer.array(sorted(topics), lambda w, t: w.string(t))
    writer.bytes_(b"")
    return writer.build()


def decode_subscription(data: bytes) -> List[str]:
    reader = Reader(data)
    reader.int16()  # version
    return reader.array(lambda r: r.string())


def encode_assignment(assignment: Dict[str, List[int]]) -> bytes:
    writer = Writer().int16(0)
    writer.array(
        sorted(assignment.items()),
        lambda w, item: (
            w.string(item[0]),
            w.array(item[1], lambda w2, p: w2.int32(p)),
        ),
    )
    writer.bytes_(b"")
    return writer.build()


def decode_assignment(data: bytes) -> Dict[str, List[int]]:
    if not data:
        return {}
    reader = Reader(data)
    reader.int16()
    out: Dict[str, List[int]] = {}
    for _ in range(reader.int32()):
        topic = reader.string()
        out[topic] = reader.array(lambda r: r.int32())
    return out


def range_assign(
    members: List[Tuple[str, List[str]]],
    partitions_by_topic: Dict[str, int],
) -> Dict[str, Dict[str, List[int]]]:
    """The leader-side range assignor: contiguous partition spans per
    member, per topic (Kafka's default RangeAssignor semantics)."""
    out: Dict[str, Dict[str, List[int]]] = {m: {} for m, _ in members}
    topics: Dict[str, List[str]] = {}
    for member_id, subscribed in members:
        for topic in subscribed:
            topics.setdefault(topic, []).append(member_id)
    for topic, member_ids in topics.items():
        member_ids.sort()
        count = partitions_by_topic.get(topic, 0)
        n = len(member_ids)
        base, extra = divmod(count, n)
        start = 0
        for i, member_id in enumerate(member_ids):
            take = base + (1 if i < extra else 0)
            if take:
                out[member_id][topic] = list(range(start, start + take))
            start += take
    return out

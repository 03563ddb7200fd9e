"""Record <-> bytes codec for the durable log runtime.

JSON envelope with a type-tagged escape for binary values (the reference's
Kafka plane delegates this to pluggable serializers + an Avro schema
registry; here dict/list values already carry their structure, so a
self-describing JSON envelope is the portable choice).

The port's own copy of ``langstream_tpu/topics/log/codec.py``: the same
bytes on disk and on the wire.
"""

from __future__ import annotations

import json

from langstream_tpu_torch.api.records import Record

# shared escape-aware codec: a literal user dict {"__b64__": "x"} now
# survives the round trip ({"__esc__": …} wrapping) instead of decoding
# as bytes; values written by older builds decode identically
from langstream_tpu_torch.utils.wire_json import (  # noqa: E402
    decode_value as _decode_value,
    encode_value as _encode_value,
)


def encode_record(record: Record) -> bytes:
    doc = {
        "v": _encode_value(record.value),
        "k": _encode_value(record.key),
        "t": record.timestamp,
        "h": [[k, _encode_value(v)] for k, v in record.headers],
    }
    return json.dumps(doc, ensure_ascii=False, default=str).encode("utf-8")


def decode_record(payload: bytes, origin: str) -> Record:
    doc = json.loads(payload.decode("utf-8"))
    return Record(
        value=_decode_value(doc.get("v")),
        key=_decode_value(doc.get("k")),
        origin=origin,
        timestamp=doc.get("t"),
        headers=tuple((k, _decode_value(v)) for k, v in doc.get("h", [])),
    )


def record_to_json(record: Record) -> dict:
    """JSON-safe dict form for the wire protocol (server <-> client)."""
    doc = {
        "v": _encode_value(record.value),
        "k": _encode_value(record.key),
        "t": record.timestamp,
        "o": record.origin,
        "h": [[k, _encode_value(v)] for k, v in record.headers],
    }
    partition = getattr(record, "partition", None)
    offset = getattr(record, "offset", None)
    if partition is not None:
        doc["p"] = partition
    if offset is not None:
        doc["off"] = offset
    return doc


def record_from_json(doc: dict) -> Record:
    from langstream_tpu_torch.topics.memory import BrokerRecord

    common = dict(
        value=_decode_value(doc.get("v")),
        key=_decode_value(doc.get("k")),
        origin=doc.get("o"),
        timestamp=doc.get("t"),
        headers=tuple((k, _decode_value(v)) for k, v in doc.get("h", [])),
    )
    if "off" in doc:
        return BrokerRecord(
            partition=doc.get("p", 0), offset=doc["off"], **common
        )
    return Record(**common)

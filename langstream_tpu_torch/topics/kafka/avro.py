"""Avro binary codec + Confluent Schema Registry client (no avro lib).

Reference: the schema plumbing in ``langstream-agents-commons`` (Avro
``GenericRecord`` converters + schema-registry serializers) that lets
reference pipelines consume records produced by the wider Kafka
ecosystem. Scope here:

- the Avro **binary** encoding for the common type lattice: null,
  boolean, int, long, float, double, bytes, string, record, enum,
  array, map, union, fixed (zigzag varints per the spec);
- the Confluent wire format: ``0x00 magic + 4-byte big-endian schema id
  + avro payload``;
- a minimal async Schema Registry REST client with an id cache.

The Kafka consumer uses this to decode foreign (non-envelope) records
into plain dict/list/scalar values when ``schemaRegistryUrl`` is
configured; producers can publish Confluent-framed Avro with
``encode_confluent``.

The port's own copy of ``langstream_tpu/topics/kafka/avro.py``; its
registry client speaks through the port's asyncio HTTP client
(``agents/http_client.py``): aiohttp is not among the card machine's
packages.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

CONFLUENT_MAGIC = 0


# ---------------------------------------------------------------------- #
# primitives
# ---------------------------------------------------------------------- #
class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise EOFError("truncated avro payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def zigzag(self) -> int:
        shift = value = 0
        while True:
            byte = self.take(1)[0]
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return (value >> 1) ^ -(value & 1)
            shift += 7


def _write_zigzag(out: bytearray, value: int) -> None:
    encoded = (value << 1) ^ (value >> 63)
    while True:
        byte = encoded & 0x7F
        encoded >>= 7
        if encoded:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


# ---------------------------------------------------------------------- #
# schema handling
# ---------------------------------------------------------------------- #
def parse_schema(schema: Any) -> Any:
    """Accept a JSON string or already-parsed schema document."""
    if isinstance(schema, str):
        try:
            return json.loads(schema)
        except ValueError:
            return schema  # a bare primitive name like "string"
    return schema


def _schema_type(schema: Any) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


# ---------------------------------------------------------------------- #
# decode
# ---------------------------------------------------------------------- #
def decode(schema: Any, reader: "_Reader") -> Any:
    kind = _schema_type(schema)
    if kind == "null":
        return None
    if kind == "boolean":
        return reader.take(1)[0] != 0
    if kind in ("int", "long"):
        return reader.zigzag()
    if kind == "float":
        return struct.unpack("<f", reader.take(4))[0]
    if kind == "double":
        return struct.unpack("<d", reader.take(8))[0]
    if kind == "bytes":
        return bytes(reader.take(reader.zigzag()))
    if kind == "string":
        return reader.take(reader.zigzag()).decode("utf-8")
    if kind == "fixed":
        return bytes(reader.take(schema["size"]))
    if kind == "enum":
        return schema["symbols"][reader.zigzag()]
    if kind == "union":
        return decode(schema[reader.zigzag()], reader)
    if kind == "array":
        out: List[Any] = []
        while True:
            count = reader.zigzag()
            if count == 0:
                return out
            if count < 0:  # block with byte size prefix
                count = -count
                reader.zigzag()
            for _ in range(count):
                out.append(decode(schema["items"], reader))
    if kind == "map":
        result: Dict[str, Any] = {}
        while True:
            count = reader.zigzag()
            if count == 0:
                return result
            if count < 0:
                count = -count
                reader.zigzag()
            for _ in range(count):
                key = reader.take(reader.zigzag()).decode("utf-8")
                result[key] = decode(schema["values"], reader)
    if kind == "record":
        record: Dict[str, Any] = {}
        for field in schema["fields"]:
            record[field["name"]] = decode(field["type"], reader)
        return record
    raise ValueError(f"unsupported avro type {kind!r}")


def decode_bytes(schema: Any, payload: bytes) -> Any:
    return decode(parse_schema(schema), _Reader(payload))


# ---------------------------------------------------------------------- #
# encode
# ---------------------------------------------------------------------- #
def encode(schema: Any, value: Any, out: Optional[bytearray] = None) -> bytes:
    if out is None:
        out = bytearray()
    kind = _schema_type(schema)
    if kind == "null":
        pass
    elif kind == "boolean":
        out.append(1 if value else 0)
    elif kind in ("int", "long"):
        _write_zigzag(out, int(value))
    elif kind == "float":
        out += struct.pack("<f", float(value))
    elif kind == "double":
        out += struct.pack("<d", float(value))
    elif kind == "bytes":
        _write_zigzag(out, len(value))
        out += value
    elif kind == "string":
        data = str(value).encode("utf-8")
        _write_zigzag(out, len(data))
        out += data
    elif kind == "fixed":
        if len(value) != schema["size"]:
            raise ValueError("fixed size mismatch")
        out += value
    elif kind == "enum":
        _write_zigzag(out, schema["symbols"].index(value))
    elif kind == "union":
        index = _pick_union_branch(schema, value)
        _write_zigzag(out, index)
        encode(schema[index], value, out)
    elif kind == "array":
        if value:
            _write_zigzag(out, len(value))
            for item in value:
                encode(schema["items"], item, out)
        _write_zigzag(out, 0)
    elif kind == "map":
        if value:
            _write_zigzag(out, len(value))
            for key, item in value.items():
                data = str(key).encode("utf-8")
                _write_zigzag(out, len(data))
                out += data
                encode(schema["values"], item, out)
        _write_zigzag(out, 0)
    elif kind == "record":
        for field in schema["fields"]:
            if field["name"] in value:
                encode(field["type"], value[field["name"]], out)
            elif "default" in field:
                encode(field["type"], field["default"], out)
            else:
                raise ValueError(f"missing record field {field['name']!r}")
    else:
        raise ValueError(f"unsupported avro type {kind!r}")
    return bytes(out)


def _pick_union_branch(union: List[Any], value: Any) -> int:
    def matches(schema: Any) -> bool:
        kind = _schema_type(schema)
        if value is None:
            return kind == "null"
        if isinstance(value, bool):
            return kind == "boolean"
        if isinstance(value, int):
            return kind in ("int", "long")
        if isinstance(value, float):
            return kind in ("float", "double")
        if isinstance(value, bytes):
            return kind in ("bytes", "fixed")
        if isinstance(value, str):
            return kind in ("string", "enum")
        if isinstance(value, list):
            return kind == "array"
        if isinstance(value, dict):
            return kind in ("record", "map")
        return False

    for index, branch in enumerate(union):
        if matches(branch):
            return index
    raise ValueError(f"no union branch for {type(value).__name__}")


# ---------------------------------------------------------------------- #
# confluent wire format + registry
# ---------------------------------------------------------------------- #
def is_confluent_framed(payload: Optional[bytes]) -> bool:
    return (
        isinstance(payload, (bytes, bytearray))
        and len(payload) >= 5
        and payload[0] == CONFLUENT_MAGIC
    )


def split_confluent(payload: bytes) -> Tuple[int, bytes]:
    schema_id = struct.unpack(">I", payload[1:5])[0]
    return schema_id, payload[5:]


def encode_confluent(schema_id: int, schema: Any, value: Any) -> bytes:
    return (
        bytes([CONFLUENT_MAGIC])
        + struct.pack(">I", schema_id)
        + encode(parse_schema(schema), value)
    )


class SchemaRegistryClient:
    """Minimal Confluent Schema Registry REST client (id-cached)."""

    def __init__(self, url: str) -> None:
        self.url = url.rstrip("/")
        self._by_id: Dict[int, Any] = {}

    async def get_schema(self, schema_id: int) -> Any:
        from langstream_tpu_torch.agents import http_client

        if schema_id in self._by_id:
            return self._by_id[schema_id]
        response = await http_client.request("GET", f"{self.url}/schemas/ids/{schema_id}")
        if response.status >= 300:
            raise IOError(
                f"schema registry HTTP {response.status} for id "
                f"{schema_id}"
            )
        payload = json.loads(await response.read())
        schema = parse_schema(payload["schema"])
        self._by_id[schema_id] = schema
        return schema

    async def register(self, subject: str, schema: Any) -> int:
        from langstream_tpu_torch.agents import http_client

        body = {"schema": json.dumps(parse_schema(schema))}
        response = await http_client.request(
            "POST", f"{self.url}/subjects/{subject}/versions", json=body)
        if response.status >= 300:
            raise IOError(
                f"schema registry HTTP {response.status} registering "
                f"{subject}"
            )
        return int(json.loads(await response.read())["id"])

    async def decode_value(self, payload: bytes) -> Any:
        schema_id, body = split_confluent(payload)
        schema = await self.get_schema(schema_id)
        return decode(schema, _Reader(body))

    async def close(self) -> None:
        """Nothing to close: each request has a connection of its own."""

"""The record model — the unit of data flowing through every pipeline.

The port's own copy of ``langstream_tpu/api/records.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's record contract
(``langstream-api/src/main/java/ai/langstream/api/runner/code/Record.java:20``
and ``SimpleRecord.java:28``): a record carries a key, a value, the topic of
origin, an event timestamp, and a set of headers.

TPU-first deviations from the reference:

- Records are immutable (frozen dataclass) — the runtime may hold a record in
  several async pipelines at once (batch coalescing for XLA calls), so
  aliasing must be safe.
- Headers are a tuple of ``(name, value)`` pairs rather than a mutable list;
  helper accessors provide dict-like reads.
- Values are plain Python objects (str / bytes / dict / list / numbers).
  Schema handling is structural: dict values behave like the reference's Avro
  GenericRecord for field access in the expression language, without dragging
  a schema registry into the core (the reference's schema plumbing lives in
  ``langstream-agents-commons`` converters).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Iterable, Mapping, Optional, Sequence, Tuple

Header = Tuple[str, Any]


@dataclasses.dataclass(frozen=True)
class Record:
    """An immutable record: key, value, origin topic, timestamp, headers.

    ``timestamp`` is epoch milliseconds, matching the reference
    (``Record.java:20`` exposes ``Long timestamp()`` in ms).
    """

    value: Any = None
    key: Any = None
    origin: Optional[str] = None
    timestamp: Optional[int] = None
    headers: Tuple[Header, ...] = ()

    # ------------------------------------------------------------------ #
    # header helpers
    # ------------------------------------------------------------------ #
    def header(self, name: str, default: Any = None) -> Any:
        """Return the value of the first header named ``name``."""
        for key, value in self.headers:
            if key == name:
                return value
        return default

    def header_values(self, name: str) -> Tuple[Any, ...]:
        return tuple(v for k, v in self.headers if k == name)

    def headers_as_dict(self) -> dict:
        """Collapse headers into a dict (last occurrence wins)."""
        return dict(self.headers)

    # ------------------------------------------------------------------ #
    # builders
    # ------------------------------------------------------------------ #
    def with_value(self, value: Any) -> "Record":
        return dataclasses.replace(self, value=value)

    def with_key(self, key: Any) -> "Record":
        return dataclasses.replace(self, key=key)

    def with_origin(self, origin: Optional[str]) -> "Record":
        return dataclasses.replace(self, origin=origin)

    def with_timestamp(self, timestamp: Optional[int]) -> "Record":
        return dataclasses.replace(self, timestamp=timestamp)

    def with_headers(self, headers: Iterable[Header]) -> "Record":
        return dataclasses.replace(self, headers=tuple(headers))

    def with_header(self, name: str, value: Any) -> "Record":
        """Return a copy with header ``name`` set (replacing existing)."""
        kept = tuple((k, v) for k, v in self.headers if k != name)
        return dataclasses.replace(self, headers=kept + ((name, value),))

    def without_header(self, name: str) -> "Record":
        return dataclasses.replace(
            self, headers=tuple((k, v) for k, v in self.headers if k != name)
        )

    # ------------------------------------------------------------------ #
    # misc
    # ------------------------------------------------------------------ #
    def value_as_text(self) -> str:
        """Best-effort textual view of the value (for prompts / logging)."""
        value = self.value
        if value is None:
            return ""
        if isinstance(value, str):
            return value
        if isinstance(value, bytes):
            return value.decode("utf-8", errors="replace")
        if isinstance(value, (dict, list)):
            return json.dumps(value, ensure_ascii=False, default=str)
        return str(value)

    def estimated_size(self) -> int:
        """Rough payload size in bytes, used by batch byte budgeting."""
        size = 0
        for part in (self.key, self.value):
            if part is None:
                continue
            if isinstance(part, bytes):
                size += len(part)
            elif isinstance(part, str):
                size += len(part.encode("utf-8", errors="replace"))
            else:
                try:
                    size += len(json.dumps(part, default=str))
                except (TypeError, ValueError):
                    size += 64
        for name, value in self.headers:
            size += len(name) + (len(str(value)) if value is not None else 0)
        return size


class SimpleRecord(Record):
    """Alias preserved for parity with the reference's ``SimpleRecord``."""


def now_millis() -> int:
    return int(time.time() * 1000)


def record_from_value(
    value: Any,
    *,
    key: Any = None,
    origin: Optional[str] = None,
    headers: Sequence[Header] = (),
    timestamp: Optional[int] = None,
) -> Record:
    """Coerce loose agent return values into a :class:`Record`.

    Mirrors the coercion rules of the reference Python SDK
    (``langstream-runtime/langstream-runtime-impl/src/main/python/langstream_grpc/api.py:34-195``):
    agents may return a Record, a bare value, a ``(key, value)`` tuple, or a
    dict with record-shaped keys.
    """
    if isinstance(value, Record):
        return value
    if isinstance(value, tuple) and len(value) == 2:
        key, value = value
    if isinstance(value, Mapping) and set(value.keys()) <= {
        "key",
        "value",
        "headers",
        "origin",
        "timestamp",
    } and "value" in value:
        headers_in = value.get("headers", ())
        if isinstance(headers_in, Mapping):
            headers_in = tuple(headers_in.items())
        return Record(
            value=value.get("value"),
            key=value.get("key", key),
            origin=value.get("origin", origin),
            timestamp=value.get("timestamp", timestamp),
            headers=tuple(headers_in),
        )
    return Record(
        value=value,
        key=key,
        origin=origin,
        timestamp=timestamp,
        headers=tuple(headers),
    )

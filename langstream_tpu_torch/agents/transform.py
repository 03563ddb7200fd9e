"""TransformContext: the uniform mutable view every GenAI step operates on.

The port's own copy of ``langstream_tpu/agents/transform.py`` (the port imports nothing
of the JAX package).

Equivalent of the reference's ``MutableRecord``
(``langstream-agents/langstream-agents-commons/src/main/java/ai/langstream/ai/agents/commons/MutableRecord.java:58``):
a record is lifted into a mutable key/value/headers structure with
path-addressable fields (``value``, ``value.question``, ``key.id``,
``properties.header-name``, ``destinationTopic``, ``timestamp``), steps
mutate it in memory, and it is lowered back to a :class:`Record` at the end
of the step chain. JSON-string values are parsed on demand so dotted paths
work over serialized payloads, mirroring the reference's schema converters.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from langstream_tpu_torch.api.records import Record, now_millis


class TransformContext:
    def __init__(self, record: Record) -> None:
        self.record = record
        self.key = record.key
        self.value = record.value
        self.properties: Dict[str, Any] = record.headers_as_dict()
        self.destination_topic: Optional[str] = None
        self.timestamp = record.timestamp
        self.dropped = False

    # ------------------------------------------------------------------ #
    # expression-language context
    # ------------------------------------------------------------------ #
    def el_context(self) -> Dict[str, Any]:
        return {
            "key": self._structured(self.key),
            "value": self._structured(self.value),
            "properties": dict(self.properties),
            "origin": self.record.origin,
            "topicName": self.record.origin,
            "timestamp": self.timestamp,
            "eventTime": self.timestamp,
        }

    @staticmethod
    def _structured(value: Any) -> Any:
        """Parse JSON strings/bytes so dotted paths reach inside them."""
        if isinstance(value, bytes):
            try:
                value = value.decode("utf-8")
            except UnicodeDecodeError:
                return value
        if isinstance(value, str):
            stripped = value.strip()
            if stripped.startswith(("{", "[")):
                try:
                    return json.loads(stripped)
                except json.JSONDecodeError:
                    return value
        return value

    # ------------------------------------------------------------------ #
    # path-addressable fields
    # ------------------------------------------------------------------ #
    def get_field(self, path: str) -> Any:
        root, rest = self._split(path)
        if root == "value":
            node = self._structured(self.value)
        elif root == "key":
            node = self._structured(self.key)
        elif root == "properties":
            node = self.properties
        elif root == "destinationTopic":
            return self.destination_topic
        elif root == "timestamp":
            return self.timestamp
        else:
            raise KeyError(f"unknown field root {root!r} in path {path!r}")
        for part in rest:
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return None
        return node

    def set_field(self, path: str, new_value: Any) -> None:
        root, rest = self._split(path)
        if root == "destinationTopic":
            self.destination_topic = new_value
            return
        if root == "timestamp":
            self.timestamp = new_value
            return
        if root == "properties":
            if not rest:
                raise KeyError("cannot replace the whole properties map")
            self.properties[rest[0]] = new_value
            return
        if root not in ("value", "key"):
            raise KeyError(f"unknown field root {root!r} in path {path!r}")
        if not rest:
            setattr(self, root, new_value)
            return
        container = self._structured(getattr(self, root))
        if container is None:
            container = {}
        elif not isinstance(container, dict):
            # silently discarding a scalar value would lose data (e.g. the
            # chunk text after text-splitter); fail loudly like the
            # reference's schema layer would
            raise ValueError(
                f"cannot set field {'.'.join(rest)!r} on non-object {root} "
                f"of type {type(container).__name__}; convert the record "
                "first (e.g. document-to-json)"
            )
        node = container
        for part in rest[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[rest[-1]] = new_value
        setattr(self, root, container)

    def delete_field(self, path: str) -> None:
        root, rest = self._split(path)
        if root == "properties" and rest:
            self.properties.pop(rest[0], None)
            return
        if root in ("value", "key"):
            if not rest:
                setattr(self, root, None)
                return
            container = self._structured(getattr(self, root))
            node = container
            for part in rest[:-1]:
                if not isinstance(node, dict):
                    return
                node = node.get(part)
            if isinstance(node, dict):
                node.pop(rest[-1], None)
            setattr(self, root, container)

    @staticmethod
    def _split(path: str):
        parts = path.split(".")
        return parts[0], parts[1:]

    # ------------------------------------------------------------------ #
    # lowering
    # ------------------------------------------------------------------ #
    def to_record(self) -> Record:
        return Record(
            value=self.value,
            key=self.key,
            origin=self.record.origin,
            timestamp=self.timestamp or now_millis(),
            headers=tuple(self.properties.items()),
        )

"""Typed payload envelope shared by the external-broker runtimes.

The port's own copy of ``langstream_tpu/topics/serde.py`` (the port imports nothing
of the JAX package).

Python record values (str / bytes / dict / list / numbers / None) must
round-trip through brokers that only carry bytes. Each payload travels
with a one-letter kind tag (``s``/``b``/``j``/``n``); foreign records
(no tag) decode as UTF-8 text, falling back to raw bytes — the same
contract the reference gets from configurable serializers.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple


def encode_payload(value: Any) -> Tuple[Optional[bytes], str]:
    if value is None:
        return None, "n"
    if isinstance(value, bytes):
        return value, "b"
    if isinstance(value, str):
        return value.encode("utf-8"), "s"
    return json.dumps(value).encode("utf-8"), "j"


def decode_payload(data: Optional[bytes], kind: Optional[str]) -> Any:
    if data is None or kind == "n":
        return None
    if kind == "b":
        return data
    if kind == "j":
        return json.loads(data.decode("utf-8"))
    if kind == "s":
        return data.decode("utf-8")
    try:  # foreign record: no envelope
        return data.decode("utf-8")
    except UnicodeDecodeError:
        return data

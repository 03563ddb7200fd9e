"""Escape-aware JSON value codec of the wire surfaces.

The port's own copy of ``langstream_tpu/utils/wire_json.py`` (the port
imports nothing of the JAX package): the ``{"__b64__": …}`` binary
escape of the process-isolation boundary (``agents/isolation.py``), the
same bytes on the wire as the JAX package's. Deliberately NOT pickle —
nothing executable crosses a wire.

Domain: the JSON-shaped record value domain (str/num/bool/None, lists,
dicts with string keys) plus ``bytes``. Literal user dicts whose key
set collides with an escape marker are wrapped in ``{"__esc__": …}`` so
the codec stays bijective over its domain (a plain tag-check codec
would silently decode ``{"__b64__": "x"}`` written BY THE USER into
bytes). Non-string dict keys are stringified — a JSON limitation shared
by every broker codec in this framework.

Transports may register additional markers (the isolation boundary adds
``__record__``) by passing ``extra_markers``.
"""

from __future__ import annotations

import base64
from typing import Any, Callable, Dict, Optional, Tuple

BYTES_TAG = "__b64__"
ESC_TAG = "__esc__"

_BASE_MARKERS: Tuple[frozenset, ...] = (
    frozenset((BYTES_TAG,)),
    frozenset((ESC_TAG,)),
)


def encode_value(
    value: Any,
    *,
    extra_markers: Tuple[frozenset, ...] = (),
    encode_special: Optional[Callable[[Any], Optional[Dict[str, Any]]]] = None,
) -> Any:
    """Encode ``value`` into the JSON-safe escaped form.

    ``encode_special(value)`` may return a marker dict for
    transport-specific types (e.g. Records) or None to fall through."""
    if encode_special is not None:
        special = encode_special(value)
        if special is not None:
            return special
    if isinstance(value, (bytes, bytearray, memoryview)):
        return {BYTES_TAG: base64.b64encode(bytes(value)).decode("ascii")}
    if isinstance(value, dict):
        encoded = {
            str(k): encode_value(
                v, extra_markers=extra_markers, encode_special=encode_special
            )
            for k, v in value.items()
        }
        keys = frozenset(encoded.keys())
        if keys in _BASE_MARKERS or keys in extra_markers:
            return {ESC_TAG: encoded}
        return encoded
    if isinstance(value, (list, tuple)):
        return [
            encode_value(
                v, extra_markers=extra_markers, encode_special=encode_special
            )
            for v in value
        ]
    return value


def decode_value(
    value: Any,
    *,
    extra_markers: Tuple[frozenset, ...] = (),
    decode_special: Optional[Callable[[Dict[str, Any]], Any]] = None,
) -> Any:
    """Inverse of :func:`encode_value` (pass the same
    ``extra_markers``). ``decode_special(dict)`` may claim a marker dict
    (returning the decoded object) or return the sentinel
    ``NotImplemented`` to fall through."""

    def rec(v: Any) -> Any:
        return decode_value(
            v, extra_markers=extra_markers, decode_special=decode_special
        )

    if isinstance(value, dict):
        keys = set(value.keys())
        if keys == {BYTES_TAG}:
            return base64.b64decode(value[BYTES_TAG])
        if keys == {ESC_TAG} and isinstance(value[ESC_TAG], dict):
            inner_keys = frozenset(value[ESC_TAG].keys())
            # only unwrap what OUR encoder wraps: an inner dict whose
            # key set is itself a marker set. Anything else is legacy
            # data the pre-escape codec passed through verbatim — a
            # user's literal {'__esc__': {...}} must decode as itself
            if inner_keys in _BASE_MARKERS or inner_keys in extra_markers:
                return {k: rec(v) for k, v in value[ESC_TAG].items()}
        if decode_special is not None:
            special = decode_special(value)
            if special is not NotImplemented:
                return special
        return {k: rec(v) for k, v in value.items()}
    if isinstance(value, list):
        return [rec(v) for v in value]
    return value

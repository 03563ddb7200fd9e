"""Typed serving errors the HTTP surface answers with 503.

The port's own copy of the retryable errors of
``langstream_tpu/api/errors.py`` (the record-processing policy there is
not part of the port).
"""

from __future__ import annotations


class UnavailableError(RuntimeError):
    """Transient unavailability the CALLER should retry: the request never
    started (no partial work), and ``retry_after_s`` estimates when
    capacity returns. The OpenAI surface answers it with HTTP 503 and
    ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


class QueueTimeoutError(UnavailableError):
    """A pending request outlived its admission deadline and was shed
    before it held a slot (load shedding). ``retry_after_s`` derives from
    the queue depth and the engine's EWMA step time."""


class EngineRebuildingError(UnavailableError):
    """The engine supervisor is rebuilding a crashed engine: live sessions
    are being resurrected, and new work must retry after the rebuild."""

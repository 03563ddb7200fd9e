"""Typed serving errors, and the record-processing error policy.

The port's own copy of ``langstream_tpu/api/errors.py``: the retryable
errors the HTTP surface answers with 503, and the reference's
``ErrorsSpec`` (``ErrorsSpec.java:26``) with ``StandardErrorsHandler``
(``StandardErrorsHandler.java:28``): each agent declares ``on-failure``
(fail | skip | dead-letter) and ``retries``; pipeline-level defaults
flow into agents that don't override them (``ErrorsSpec.withDefaultsFrom``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional


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


class FatalAgentError(RuntimeError):
    """Errors the record-level policy must NEVER consume: the agent
    cannot make progress (dead child process, poisoned device state),
    so retry/skip/dead-letter would silently drop every subsequent
    record. The runner re-raises these fatally so the pod restarts —
    the analogue of the reference's JVM-exit main error handler
    (``AgentRunner.java:87-91`` ``mainErrorHandler``)."""


class FailureAction(enum.Enum):
    FAIL = "fail"
    SKIP = "skip"
    DEAD_LETTER = "dead-letter"


@dataclasses.dataclass(frozen=True)
class ErrorsSpec:
    """``retries`` + ``on-failure`` with defaults inheritance."""

    retries: Optional[int] = None
    on_failure: Optional[str] = None

    DEFAULT_RETRIES = 0
    DEFAULT_ON_FAILURE = FailureAction.FAIL

    @classmethod
    def from_config(cls, config: Optional[Dict[str, Any]]) -> "ErrorsSpec":
        if not config:
            return cls()
        return cls(
            retries=config.get("retries"),
            on_failure=config.get("on-failure", config.get("on_failure")),
        )

    def with_defaults_from(self, defaults: "ErrorsSpec") -> "ErrorsSpec":
        """Fill unset fields from pipeline defaults
        (``ErrorsSpec.withDefaultsFrom``, ``ErrorsSpec.java:24-31``)."""
        return ErrorsSpec(
            retries=self.retries if self.retries is not None else defaults.retries,
            on_failure=(
                self.on_failure if self.on_failure is not None else defaults.on_failure
            ),
        )

    def resolved_retries(self) -> int:
        return self.retries if self.retries is not None else self.DEFAULT_RETRIES

    def resolved_action(self) -> FailureAction:
        if self.on_failure is None:
            return self.DEFAULT_ON_FAILURE
        return FailureAction(self.on_failure)

    def to_config(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.retries is not None:
            out["retries"] = self.retries
        if self.on_failure is not None:
            out["on-failure"] = self.on_failure
        return out


class ErrorHandlingDecision(enum.Enum):
    """What the runner should do after a record failure
    (reference: ``StandardErrorsHandler.ErrorsProcessingOutcome``)."""

    RETRY = "retry"
    SKIP = "skip"
    FAIL = "fail"
    DEAD_LETTER = "dead-letter"


class StandardErrorsHandler:
    """Counts failures per record attempt and decides retry/skip/fail/DLQ.

    Mirrors ``StandardErrorsHandler.java:28``: a record may be retried
    ``retries`` times; once exhausted, the action is ``on-failure``
    (dead-letter falls back to fail when no dead-letter producer exists —
    the runner handles that downgrade).
    """

    def __init__(self, spec: ErrorsSpec) -> None:
        self.spec = spec
        self.failures = 0

    def handle_error(self, attempts_for_record: int) -> ErrorHandlingDecision:
        self.failures += 1
        if attempts_for_record <= self.spec.resolved_retries():
            return ErrorHandlingDecision.RETRY
        action = self.spec.resolved_action()
        if action is FailureAction.SKIP:
            return ErrorHandlingDecision.SKIP
        if action is FailureAction.DEAD_LETTER:
            return ErrorHandlingDecision.DEAD_LETTER
        return ErrorHandlingDecision.FAIL

"""Engine flight recorder — crash-surviving evidence on disk.

The port's own copy of ``langstream_tpu/runtime/flight.py``. A bounded
in-memory ring of samples, flushed periodically and at a crash or exit to
a JSONL artifact, so a serve run that dies leaves on-disk evidence of
why, and ``tools/ab_analyze.py`` and the journey ledger
(``runtime/journey.py``) have the per-dispatch series to digest.

One artifact per process under ``<dir>/flight_<utc>_<pid>.jsonl``; each
line is ``{"ts": <epoch s>, "kind": <sample kind>, ...fields}``, the
first a ``meta`` record. Kinds the port writes:

- ``engine_start``      — engine built: slots, ctx, layout, device
- ``prefill``           — one prefill call: bucket, batch, warm, reused
  tokens, wall_ms, queue depth, modeled flops
- ``decode_chunk``      — one decode chunk or mixed step (``mixed``=1):
  steps, active, slots, step_ms, queue depth, kv_frac, cumulative tokens,
  the chunk's MFU and MBU, the goodput ledger's running totals
- ``request``           — one finished request: trace_id, tokens,
  finish_reason, ttft_ms, tpot_ms
- ``journey``           — one finished request leg's stages
  (``runtime/journey.py``), joined by ``python -m langstream_tpu_torch
  journey``
- ``engine_crash``      — the engine loop died: error repr
- ``engine_stop``       — clean engine shutdown and its counters
- ``fault_injected``    — a deterministic chaos fault fired
  (``runtime/faults.py``): point, arrival, spec
- ``engine_recovery``   — the supervisor's heal arc
  (``runtime/supervisor.py``): phase begin / complete / gave_up /
  rebuild_failed, sessions, recovery_s
- ``session_resume``    — one resurrected session fast-forwarded: slot,
  replayed tokens, reused prefix tokens
- ``request_shed``      — a pending request failed fast at its admission
  deadline: waited_s, queue_depth, retry_after_s
- ``watchdog_trip`` / ``watchdog_escalation`` / ``watchdog_capture`` —
  the decode-stall watchdog (``runtime/watchdog.py``)

The ``meta`` record also carries ``replica`` and ``fleet_role`` once
:func:`set_identity` has stamped the process (``serve`` stamps its host
name), so the journey ledger tells the replicas of a fleet apart.

Disabled (the default) a record is one ``if``; enable it with
:func:`configure` or the ``LANGSTREAM_FLIGHT_DIR`` environment variable
(every engine construction calls :func:`configure_from_env`).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

ENV_VAR = "LANGSTREAM_FLIGHT_DIR"


class FlightRecorder:
    def __init__(self, capacity: int = 8192, flush_interval: float = 5.0) -> None:
        self.capacity = capacity
        self.flush_interval = flush_interval
        # written once under the lock by configure(); record()'s lock-free
        # read is the disabled gate
        self.path: Optional[str] = None
        self.dropped = 0
        # the process's replica id and role, stamped into the meta record
        self.identity: Dict[str, str] = {}
        self._pending: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._last_flush = 0.0
        self._atexit_registered = False

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def configure(self, directory: str, run_id: Optional[str] = None) -> str:
        """Open (or re-target) the artifact file; idempotent per
        directory. Writes the ``meta`` line at once, so even a process
        that dies before any sample leaves a file."""
        with self._lock:
            if self.path is not None and os.path.dirname(self.path) == directory:
                return self.path
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            self.path = os.path.join(directory, f"flight_{stamp}_{os.getpid()}.jsonl")
            if not self._atexit_registered:
                self._atexit_registered = True
                atexit.register(self.flush)
            identity = dict(self.identity)
        self.record("meta", pid=os.getpid(), run_id=run_id or "", argv=" ".join(sys.argv[:4]),
                    **identity)
        self.flush()
        return self.path

    def set_identity(self, replica: Optional[str], fleet_role: Optional[str] = None) -> None:
        """Stamp this process's replica id and role. Before
        :meth:`configure` it rides the artifact's first ``meta`` record;
        after, a further ``meta`` record carries it (readers take the last
        value seen)."""
        with self._lock:
            if replica:
                self.identity["replica"] = str(replica)
            if fleet_role:
                self.identity["fleet_role"] = str(fleet_role)
            identity = dict(self.identity)
            enabled = self.path is not None
        if enabled and identity:
            self.record("meta", pid=os.getpid(), **identity)

    def record(self, kind: str, **fields: Any) -> None:
        """Append one sample; a no-op when disabled. Flushes when
        ``flush_interval`` has passed since the last write, so a hard kill
        loses at most one interval."""
        if self.path is None:
            return
        entry = {"ts": round(time.time(), 6), "kind": kind}
        entry.update(fields)
        with self._lock:
            if len(self._pending) == self._pending.maxlen:
                self.dropped += 1
            self._pending.append(entry)
            due = time.monotonic() - self._last_flush >= self.flush_interval
        if due:
            self.flush()

    def flush(self) -> None:
        """Drain the ring to the artifact (append-only JSONL)."""
        with self._lock:
            if self.path is None or not self._pending:
                return
            batch: List[Dict[str, Any]] = list(self._pending)
            self._pending.clear()
            self._last_flush = time.monotonic()
            path = self.path
            if self.dropped:
                batch.insert(0, {"ts": round(time.time(), 6), "kind": "dropped",
                                 "count": self.dropped})
                self.dropped = 0
        try:
            with open(path, "a", encoding="utf-8") as handle:
                for entry in batch:
                    handle.write(json.dumps(entry) + "\n")
        except OSError:
            pass  # a full or read-only disk must never take serving down


RECORDER = FlightRecorder()


def configure(directory: str, run_id: Optional[str] = None) -> str:
    return RECORDER.configure(directory, run_id=run_id)


def configure_from_env() -> Optional[str]:
    directory = os.environ.get(ENV_VAR, "")
    if directory and not RECORDER.enabled:
        return RECORDER.configure(directory)
    return RECORDER.path


def set_identity(replica: Optional[str], fleet_role: Optional[str] = None) -> None:
    RECORDER.set_identity(replica, fleet_role)


def get_identity() -> Dict[str, str]:
    with RECORDER._lock:
        return dict(RECORDER.identity)


def record(kind: str, **fields: Any) -> None:
    RECORDER.record(kind, **fields)


def flush() -> None:
    RECORDER.flush()


def read_artifact(path: str) -> List[Dict[str, Any]]:
    """Parse a flight JSONL artifact, skipping a torn final line (the
    process may have died mid-write)."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as handle:
        for line in handle:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out

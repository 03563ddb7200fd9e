"""Span tracing and on-demand device profiling.

The port's own copy of what the engine supervisor needs of
``langstream_tpu/runtime/tracing.py``: completed spans recorded with
:meth:`Tracer.event` (the supervisor's ``engine.recovery``), kept in a
bounded ring per :class:`Tracer` and dumped as Chrome ``trace_event``
JSON (``chrome://tracing``, Perfetto) when ``LANGSTREAM_TRACE_DIR`` is
set. Off (the default), every call site gets the shared no-op tracer and
pays one attribute check.

:func:`profile` is the JAX module's ``profile`` over ``torch.profiler``:
everything the card and the host run inside the block lands in one
Chrome trace. :func:`capture` runs it for N seconds, one capture at a
time per process; the watchdog's trip evidence is such a capture.

The JAX module's nesting span context manager and its trace-merge and
summary tools are not ported.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)


def trace_dir() -> str:
    """Directory for per-process Chrome-trace dumps; empty = tracing off."""
    return os.environ.get("LANGSTREAM_TRACE_DIR", "")


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_wall", "duration_ns",
                 "attributes")

    def __init__(self, name: str, trace_id: str, span_id: int, parent_id: Optional[int],
                 attributes: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_wall = time.time()
        self.duration_ns: Optional[int] = None
        self.attributes: Dict[str, Any] = attributes or {}


class Tracer:
    """Per-component span recorder with a bounded buffer."""

    def __init__(self, component: str, max_spans: int = 4096) -> None:
        self.component = component
        self.enabled = True
        self._spans: Deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._counter = 0

    def _next_id(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    def event(self, name: str, duration_s: float, *, trace_id: str = "",
              start_wall: Optional[float] = None, **attributes: Any) -> None:
        """Record an already-completed span from times taken elsewhere."""
        if not self.enabled:
            return
        span = Span(name, trace_id, self._next_id(), None, attributes)
        if start_wall is not None:
            span.start_wall = start_wall
        span.duration_ns = max(0, int(duration_s * 1e9))
        with self._lock:
            self._spans.append(span)

    def chrome_trace(self) -> List[Dict[str, Any]]:
        """Chrome trace_event "X" (complete) events."""
        with self._lock:
            spans = list(self._spans)
        return [{
            "name": span.name, "cat": self.component, "ph": "X", "ts": span.start_wall * 1e6,
            "dur": span.duration_ns / 1e3, "pid": 0, "tid": span.parent_id or span.span_id,
            "args": {"trace_id": span.trace_id, **span.attributes},
        } for span in spans if span.duration_ns is not None]

    def dump(self, path: str) -> None:
        with open(path, "w") as handle:
            json.dump({"traceEvents": self.chrome_trace()}, handle)


class NoopTracer(Tracer):
    """The shared do-nothing tracer (tracing off)."""

    def __init__(self) -> None:
        super().__init__("noop", max_spans=1)
        self.enabled = False


NOOP = NoopTracer()

_TRACERS: Dict[str, Tracer] = {}
_REGISTRY_LOCK = threading.Lock()
_DUMP_REGISTERED = False


def get_tracer(component: str) -> Tracer:
    """The process-wide tracer of a component (``engine``, ...): the
    no-op tracer unless ``LANGSTREAM_TRACE_DIR`` is set; real tracers are
    dumped there at exit (and by :func:`dump_all`)."""
    global _DUMP_REGISTERED
    if not trace_dir():
        return NOOP
    with _REGISTRY_LOCK:
        tracer = _TRACERS.get(component)
        if tracer is None:
            tracer = _TRACERS[component] = Tracer(component)
        if not _DUMP_REGISTERED:
            _DUMP_REGISTERED = True
            atexit.register(dump_all)
    return tracer


def dump_all(directory: Optional[str] = None) -> List[str]:
    """One Chrome-trace JSON per registered tracer, named by component and
    pid; returns the paths written."""
    directory = directory or trace_dir()
    if not directory:
        return []
    os.makedirs(directory, exist_ok=True)
    with _REGISTRY_LOCK:
        tracers = dict(_TRACERS)
    paths = []
    for component, tracer in tracers.items():
        if tracer.chrome_trace():
            path = os.path.join(directory, f"trace_{component}_{os.getpid()}.json")
            tracer.dump(path)
            paths.append(path)
    return paths


# ---------------------------------------------------------------------- #
# device profiling
# ---------------------------------------------------------------------- #
PROFILE_DIR_ENV = "LANGSTREAM_PROFILE_DIR"
MAX_PROFILE_SECONDS = 60.0


class ProfileBusyError(RuntimeError):
    """A profiler capture is already running in this process."""


# one capture at a time: the profiler is a process-wide singleton. The
# engine supervisor also holds it while it rebuilds, so no capture ever
# overlaps a CUDA graph capture
PROFILE_LOCK = threading.Lock()


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[Any]:
    """Profile everything run inside the block (the card's kernels and
    copies when CUDA is available, the host's operators) into
    ``log_dir/trace.json``, a Chrome trace; yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profiler:
        yield profiler
    profiler.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def capture(seconds: float, base_dir: Optional[str] = None) -> str:
    """One :func:`profile` of ``seconds`` while serving goes on, into
    ``<base_dir>/<utc>_<pid>/`` (default ``$LANGSTREAM_PROFILE_DIR``, else
    ``bench_artifacts/profiles`` under the working directory); returns
    the directory. Raises :class:`ProfileBusyError` while another capture
    (or a supervisor rebuild) holds the profiler."""
    seconds = float(seconds)
    if not 0 < seconds <= MAX_PROFILE_SECONDS:
        raise ValueError(f"seconds must be in (0, {MAX_PROFILE_SECONDS:.0f}], got {seconds}")
    if not PROFILE_LOCK.acquire(blocking=False):
        raise ProfileBusyError("a profiler capture is already in progress (one at a time)")
    try:
        base = base_dir or os.environ.get(PROFILE_DIR_ENV) or os.path.join(
            "bench_artifacts", "profiles")
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        directory = os.path.join(base, f"{stamp}_{os.getpid()}")
        with profile(directory):
            time.sleep(seconds)
        logger.info("profiler capture (%.1fs) -> %s", seconds, directory)
        return directory
    finally:
        PROFILE_LOCK.release()

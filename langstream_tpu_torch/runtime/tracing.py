"""Span tracing and on-demand device profiling.

The port's own copy of ``langstream_tpu/runtime/tracing.py``'s spans:
nesting spans (:meth:`Tracer.span`) and completed ones recorded from
times taken elsewhere (:meth:`Tracer.event`: the engine's
``engine.request`` and ``engine.decode_chunk``, whose ``trace_ids``
attribute lists every rider's trace id, and the supervisor's
``engine.recovery``), kept in a bounded ring per :class:`Tracer` and
dumped as Chrome ``trace_event`` JSON (``chrome://tracing``, Perfetto)
when ``LANGSTREAM_TRACE_DIR`` is set. Off (the default), every call site
gets the shared no-op tracer and pays one attribute check. A request's
trace id (:func:`new_trace_id`, or the client's
``x-langstream-trace-id`` header) tags its spans and its journey.

:func:`profile` is the JAX module's ``profile`` over ``torch.profiler``:
everything the card and the host run inside the block lands in one
Chrome trace. :func:`capture` runs it for N seconds, one capture at a
time per process (its kernels recorded from any thread once
:func:`prime_profiler` has run in the thread that imported torch), and writes the card's memory
statistics beside it
(:func:`device_memory_snapshot`, the JAX ``profiling.py``'s); it backs
``GET /debug/profile``, and the watchdog's trip evidence is such a
capture.

The JAX module's trace-merge and summary tools are not ported.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

logger = logging.getLogger(__name__)

# the HTTP trace context, the JAX server's: a client sends this header (or
# a body ``trace_id``), the server mints an id without one and echoes it,
# and the engine tags the request's spans and journey with it
HTTP_TRACE_HEADER = "x-langstream-trace-id"
# the record header that carries a trace id from the gateway through every
# topic hop and agent into the engine (the JAX package's TRACE_ID_HEADER)
TRACE_ID_HEADER = "langstream-trace-id"


def new_trace_id() -> str:
    return uuid.uuid4().hex


def trace_dir() -> str:
    """Directory for per-process Chrome-trace dumps; empty = tracing off."""
    return os.environ.get("LANGSTREAM_TRACE_DIR", "")


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_wall", "start_ns",
                 "duration_ns", "attributes")

    def __init__(self, name: str, trace_id: str, span_id: int, parent_id: Optional[int],
                 attributes: Optional[Dict[str, Any]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_wall = time.time()
        self.start_ns = time.perf_counter_ns()
        self.duration_ns: Optional[int] = None
        self.attributes: Dict[str, Any] = attributes or {}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "start": self.start_wall,
            "duration_ms": None if self.duration_ns is None else self.duration_ns / 1e6,
            "attributes": self.attributes,
        }


class Tracer:
    """Per-component span recorder with a bounded buffer."""

    def __init__(self, component: str, max_spans: int = 4096) -> None:
        self.component = component
        self.enabled = True
        self._spans: Deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._counter = 0
        # a ContextVar, not a thread-local: spans opened around awaits in
        # concurrent tasks of one event loop must not cross-link
        self._current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
            f"span_{component}", default=None)

    def _next_id(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str = "", **attributes: Any) -> Iterator[Span]:
        """Record a span around the block; it nests under the current
        context's open span and inherits its trace id."""
        if not self.enabled:
            yield _NOOP_SPAN
            return
        parent = self._current.get()
        span = Span(name, trace_id or (parent.trace_id if parent else ""), self._next_id(),
                    parent.span_id if parent else None, attributes)
        token = self._current.set(span)
        try:
            yield span
        finally:
            span.duration_ns = time.perf_counter_ns() - span.start_ns
            self._current.reset(token)
            with self._lock:
                self._spans.append(span)

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

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [span.to_dict() for span in self._spans]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

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


class _NoopSpan:
    __slots__ = ()

    @property
    def attributes(self) -> Dict[str, Any]:
        # a fresh dict per access: a caller may write into a live span's
        # attributes, and the shared no-op must keep no state
        return {}

    def __setattr__(self, *_args) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


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


_PRIMED = False


def prime_profiler() -> None:
    """Initialise the profiler's device tracing in the calling thread,
    once per process. Kineto, under ``torch.profiler``, initialises its
    client in the thread that first profiles, and that must be the thread
    that imported torch: a first capture started from a request
    handler's thread (or the watchdog's) records no kernel at all. The
    price: CUPTI stays attached for the life of the process, and every
    later launch pays for it (a graph replay's host time several times
    over, an eager launch's by about half); tearing it down after each
    session instead hangs a later capture beside CUDA graph replays. So
    only ``serve --profile-kernels`` calls this, from its main thread."""
    global _PRIMED
    import torch

    if _PRIMED or not torch.cuda.is_available():
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    _PRIMED = True


def device_memory_snapshot() -> List[Dict[str, Any]]:
    """Each visible card's memory statistics (``torch.cuda.memory_stats``:
    bytes allocated and reserved, current and peak) beside its name and
    total memory; an empty list without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return []
    out: List[Dict[str, Any]] = []
    for index in range(torch.cuda.device_count()):
        properties = torch.cuda.get_device_properties(index)
        out.append({"id": index, "platform": "gpu", "kind": properties.name,
                    "total_bytes": properties.total_memory,
                    "memory_stats": dict(torch.cuda.memory_stats(index))})
    return out


def capture(seconds: float, base_dir: Optional[str] = None) -> str:
    """One :func:`profile` of ``seconds`` while serving goes on, into
    ``<base_dir>/<utc>_<pid>/`` (default ``$LANGSTREAM_PROFILE_DIR``, else
    ``bench_artifacts/profiles`` under the working directory): its
    ``trace.json`` and ``device_memory.json`` (:func:`device_memory_snapshot`);
    returns the directory. Raises ``ValueError`` on a duration outside
    (0, 60] and :class:`ProfileBusyError` while another capture (or a
    supervisor rebuild) holds the profiler."""
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
        started = time.perf_counter()
        with profile(directory):
            time.sleep(seconds)
        snapshot = {"captured_s": round(time.perf_counter() - started, 3),
                    "devices": device_memory_snapshot()}
        with open(os.path.join(directory, "device_memory.json"), "w", encoding="utf-8") as handle:
            json.dump(snapshot, handle, indent=2)
        logger.info("profiler capture (%.1fs) -> %s", seconds, directory)
        return directory
    finally:
        PROFILE_LOCK.release()

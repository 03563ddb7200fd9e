"""Counters, histograms and the Prometheus text renderer.

The port's own copy of what ``langstream_tpu/api/metrics.py`` gives the
engine supervisor, the watchdog, the agent runner, the gateway and the
``/metrics`` routes: :class:`Counter`, :class:`Histogram`,
:class:`MetricsReporter` and :func:`prometheus_text`, the
same classic exposition (format 0.0.4), so the port's ``/metrics`` and
the JAX server's render a series alike.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Mapping, Optional, Tuple


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        # increments serialize under the lock; value() reads lock-free
        self._value = 0
        self._lock = threading.Lock()

    def count(self, amount: int = 1) -> None:
        with self._lock:
            self._value += amount

    def value(self) -> int:
        return self._value


class Histogram:
    """Fixed-bucket histogram: cumulative ``le`` buckets, sum and count."""

    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets=None) -> None:
        self.name = name
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        index = len(self.buckets)
        for i, upper in enumerate(self.buckets):
            if value <= upper:
                index = i
                break
        with self._lock:
            self._counts[index] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Dict[str, float]:
        """Cumulative bucket counts keyed by ``le``, plus sum and count."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        out: Dict[str, float] = {}
        running = 0
        for upper, count in zip(self.buckets, counts):
            running += count
            out[f"{upper}"] = running
        out["+Inf"] = running + counts[-1]
        out["sum"] = total_sum
        out["count"] = total_count
        return out


class MetricsReporter:
    """Namespaced counter/histogram registry; ``with_prefix`` mirrors the
    reference's ``MetricsReporter.withPodName/withAgentName`` chaining."""

    def __init__(self, prefix: str = "") -> None:
        self.prefix = prefix
        # registry dicts: inserts hold the lock (get-or-create races
        # must not lose a counter); with_prefix SHARES the dicts with
        # the child reporter by reference, which is a lock-free read
        self._counters: Dict[str, Counter] = {}  # guarded-by: _lock (writes)
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: _lock (writes)
        self._lock = threading.Lock()

    def with_prefix(self, prefix: str) -> "MetricsReporter":
        child = MetricsReporter(
            f"{self.prefix}_{prefix}" if self.prefix else prefix
        )
        child._counters = self._counters  # shared registry
        child._histograms = self._histograms
        child._lock = self._lock
        return child

    def counter(self, name: str) -> Counter:
        full = f"{self.prefix}_{name}" if self.prefix else name
        with self._lock:
            counter = self._counters.get(full)
            if counter is None:
                counter = Counter(full)
                self._counters[full] = counter
            return counter

    def histogram(self, name: str, buckets=None) -> Histogram:
        full = f"{self.prefix}_{name}" if self.prefix else name
        with self._lock:
            histogram = self._histograms.get(full)
            if histogram is None:
                histogram = Histogram(full, buckets)
                self._histograms[full] = histogram
            return histogram

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {name: c.value() for name, c in self._counters.items()}

    def histogram_snapshots(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            histograms = dict(self._histograms)
        return {name: h.snapshot() for name, h in histograms.items()}


_METRIC_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    metric = _METRIC_NAME.sub("_", name)
    if metric and metric[0].isdigit():
        metric = "_" + metric
    return metric


def _split_labels(name: str) -> Tuple[str, str]:
    """``metric{label="v"}`` → (sanitized metric, label suffix verbatim)."""
    base, brace, labels = name.partition("{")
    return _sanitize(base), (brace + labels) if brace else ""


def prometheus_text(
    counters: Mapping[str, int],
    gauges: Optional[Mapping[str, float]] = None,
    histograms: Optional[Mapping[str, Mapping[str, float]]] = None,
    help_texts: Optional[Mapping[str, str]] = None,
) -> str:
    """Counters, gauges and histogram snapshots in the Prometheus text
    exposition. Counter and gauge keys may carry inline labels
    (``name{reason="x"}``); samples of one family share one HELP/TYPE
    header; a metric without a help text gets a generic one."""

    def help_line(metric: str, raw: str, kind: str) -> str:
        text = (help_texts or {}).get(raw) or f"langstream-tpu {kind}"
        return f"# HELP {metric} {text}"

    def render(samples, kind: str, suffix: str = "") -> None:
        # sorted by (family, labels), not by raw key: "_" sorts before
        # "{", and raw order could split one family into two headers
        parsed = []
        for name, value in samples.items():
            metric, labels = _split_labels(name)
            if suffix and not metric.endswith(suffix):
                metric += suffix
            parsed.append((metric, labels, name.partition("{")[0], value))
        family = None
        for metric, labels, raw, value in sorted(parsed):
            if metric != family:
                family = metric
                lines.append(help_line(metric, raw, kind))
                lines.append(f"# TYPE {metric} {kind}")
            lines.append(f"{metric}{labels} {value}")

    lines: List[str] = []
    render(counters, "counter", suffix="_total")
    render(gauges or {}, "gauge")
    for name, snapshot in sorted((histograms or {}).items()):
        metric = _sanitize(name)
        lines.append(help_line(metric, name, "histogram"))
        lines.append(f"# TYPE {metric} histogram")
        for le, value in snapshot.items():
            if le in ("sum", "count"):
                continue
            lines.append(f'{metric}_bucket{{le="{le}"}} {int(value)}')
        lines.append(f"{metric}_sum {snapshot.get('sum', 0.0)}")
        lines.append(f"{metric}_count {int(snapshot.get('count', 0))}")
    return "\n".join(lines) + "\n"

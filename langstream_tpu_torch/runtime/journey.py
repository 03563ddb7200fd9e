"""Request journeys: per-request latency attribution by stage.

The port's own copy of ``langstream_tpu/runtime/journey.py``. Every
finished (or handed-off) request leg emits one ``journey`` flight record
keyed by its trace id, whose stages tile the leg's wall clock; this
module joins flight artifacts (the port's and the JAX package's alike:
the record schema is shared) back into per-request waterfalls,
per-stage percentiles and SLO blame. ``python -m langstream_tpu_torch
journey`` is :func:`run_journey`.

Record schema, one per leg::

    {"ts": <epoch s>, "kind": "journey", "trace_id": ...,
     "session_id": ..., "replica": ..., "finish_reason": ...,
     "tokens": N, "admit_class": "cold"|"hbm-hit"|"host-promote"|
     "handoff-import", "first_token": <wall s or absent>,
     "stages": [{"stage": <name>, "start": <wall s>, "end": <wall s>,
                 ...attrs}]}

Stage names (``STAGES``): ``route`` (a router's decision), ``queue``,
``admit`` (zero-width, with the admission class), ``prefill``,
``handoff_export`` / ``handoff_transit`` / ``handoff_import`` (the
disaggregation hop: transit is computed on the decode side from the
export stamp the chunk-0 manifest carries), ``decode``, ``finish``.
Within a leg each stage starts where the previous one ended, so the
stages tile the leg by construction.

Blame: a TTFT violation goes to the stage with the largest overlap of
[journey start, first token], a TPOT violation to the largest overlap of
[first token, journey end].
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from langstream_tpu_torch.api.metrics import Histogram

# canonical stage set — also the tie-break order for blame
STAGES: Tuple[str, ...] = (
    "route", "queue", "admit", "prefill", "handoff_export",
    "handoff_transit", "handoff_import", "decode", "finish",
)

# stages every completed single-leg journey is expected to carry; a
# torn journey (replica died mid-request) reports what is missing
CORE_STAGES: Tuple[str, ...] = (
    "queue", "admit", "prefill", "decode", "finish",
)

ADMIT_CLASSES: Tuple[str, ...] = (
    "cold", "hbm-hit", "host-promote", "handoff-import",
)

# per-stage latency histograms: one family per stage so every /metrics
# surface (runner pod, OpenAI server, gateway) exports the same
# ``torch_engine_journey_<stage>_seconds`` buckets the ledger's offline
# percentiles are computed from. Buckets span the engine's sub-ms admit
# up through a sim-clock (or badly backlogged) multi-second queue.
_STAGE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
STAGE_SECONDS: Dict[str, Histogram] = {
    name: Histogram(
        f"torch_engine_journey_{name}_seconds", buckets=_STAGE_BUCKETS
    )
    for name in STAGES
}


def stage_histograms() -> Dict[str, Dict[str, float]]:
    """Snapshot view for ``engines_histograms()`` — and through it,
    every Prometheus surface in the process."""
    return {h.name: h.snapshot() for h in STAGE_SECONDS.values()}


def observe_stages(stages: Iterable[Mapping[str, Any]]) -> None:
    for stage in stages:
        histogram = STAGE_SECONDS.get(stage.get("stage"))
        if histogram is not None:
            histogram.observe(
                max(0.0, float(stage["end"]) - float(stage["start"]))
            )


class StageBuilder:
    """Accumulates one leg's stage events with monotonic boundaries:
    each stage's start is clamped to the previous stage's end and its
    end to its own start, so the emitted leg can never contain a
    negative or overlapping stage — the tiling invariant holds by
    construction, whatever clock skew the raw anchors carried."""

    def __init__(self) -> None:
        self.stages: List[Dict[str, Any]] = []
        self._cursor: Optional[float] = None

    def add(
        self, stage: str, start: float, end: float, **attrs: Any
    ) -> "StageBuilder":
        start = float(start)
        end = float(end)
        if self._cursor is not None:
            start = max(start, self._cursor)
        end = max(end, start)
        self._cursor = end
        event = {"stage": stage, "start": start, "end": end}
        event.update(attrs)
        self.stages.append(event)
        return self


def blame_stage(
    stages: Sequence[Mapping[str, Any]],
    first_token: Optional[float],
    kind: str,
) -> Optional[str]:
    """The dominant stage for one SLO violation: largest overlap with
    the violated window — TTFT looks before the first token, TPOT
    after. Ties break toward the canonical stage order. ``finish`` is
    bookkeeping, never a verdict."""
    if not stages:
        return None
    if first_token is None:
        lo, hi = float("-inf"), float("inf")
    elif kind == "ttft":
        lo, hi = float("-inf"), float(first_token)
    else:
        lo, hi = float(first_token), float("inf")
    best: Optional[str] = None
    best_overlap = 0.0
    for stage in stages:
        name = stage.get("stage")
        if name == "finish":
            continue
        overlap = min(float(stage["end"]), hi) - max(
            float(stage["start"]), lo
        )
        rank = STAGES.index(name) if name in STAGES else len(STAGES)
        if overlap > best_overlap or (
            overlap == best_overlap
            and best is not None
            and overlap > 0.0
            and rank < (
                STAGES.index(best) if best in STAGES else len(STAGES)
            )
        ):
            best = name
            best_overlap = overlap
    return best if best_overlap > 0.0 else None


# boundary jitter tolerance: journey anchors are wall-clock floats
# rounded independently per record; anything under a microsecond is a
# serialization artifact, not a scheduling overlap
EPS = 2e-6


class Journey:
    """One request's merged view across every replica it crossed: all
    ``journey`` records sharing a trace id, their stages flattened and
    time-sorted."""

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.records: List[Dict[str, Any]] = []

    def add(self, record: Dict[str, Any]) -> None:
        self.records.append(record)

    # -------------------------------------------------------------- #
    # merged stage view
    # -------------------------------------------------------------- #
    @property
    def stages(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for record in self.records:
            replica = record.get("replica") or ""
            for stage in record.get("stages") or ():
                event = dict(stage)
                event.setdefault("replica", replica)
                out.append(event)
        out.sort(key=lambda s: (float(s["start"]), float(s["end"])))
        return out

    @property
    def start(self) -> Optional[float]:
        stages = self.stages
        return float(stages[0]["start"]) if stages else None

    @property
    def end(self) -> Optional[float]:
        stages = self.stages
        return max(float(s["end"]) for s in stages) if stages else None

    @property
    def e2e_s(self) -> float:
        stages = self.stages
        if not stages:
            return 0.0
        return max(float(s["end"]) for s in stages) - float(
            stages[0]["start"]
        )

    @property
    def replicas(self) -> List[str]:
        """Replicas in order of first appearance on the timeline."""
        seen: List[str] = []
        for stage in self.stages:
            replica = stage.get("replica") or ""
            if replica and replica not in seen:
                seen.append(replica)
        return seen

    @property
    def first_token(self) -> Optional[float]:
        candidates = [
            float(r["first_token"]) for r in self.records
            if r.get("first_token") is not None
        ]
        return min(candidates) if candidates else None

    @property
    def tokens(self) -> int:
        return max(
            (int(r.get("tokens") or 0) for r in self.records), default=0
        )

    @property
    def admit_classes(self) -> List[str]:
        return [
            str(r["admit_class"]) for r in self.records
            if r.get("admit_class")
        ]

    @property
    def finished(self) -> bool:
        return any(
            s.get("stage") == "finish" for s in self.stages
        )

    def missing_stages(self) -> List[str]:
        present = {s.get("stage") for s in self.stages}
        return [s for s in CORE_STAGES if s not in present]

    # -------------------------------------------------------------- #
    # the tiling invariant
    # -------------------------------------------------------------- #
    def coverage(self) -> float:
        """Fraction of the journey's end-to-end wall covered by the
        union of its stage intervals (1.0 = the stages tile the whole
        request; a gap means somebody's time went unattributed)."""
        stages = self.stages
        if not stages:
            return 0.0
        e2e = self.e2e_s
        if e2e <= 0.0:
            return 1.0
        covered = 0.0
        cursor = float(stages[0]["start"])
        for stage in stages:
            start = max(float(stage["start"]), cursor)
            end = float(stage["end"])
            if end > start:
                covered += end - start
                cursor = end
        return covered / e2e

    def overlaps(self) -> List[Tuple[str, str, float]]:
        """Pairs of stages whose intervals overlap by more than EPS —
        double-billed wall clock the blame table would misattribute."""
        out: List[Tuple[str, str, float]] = []
        stages = self.stages
        for i, stage in enumerate(stages):
            for other in stages[i + 1:]:
                if float(other["start"]) >= float(stage["end"]) - EPS:
                    break
                amount = min(
                    float(stage["end"]), float(other["end"])
                ) - float(other["start"])
                if amount > EPS:
                    out.append(
                        (stage["stage"], other["stage"], amount)
                    )
        return out

    def negatives(self) -> List[str]:
        return [
            s["stage"] for s in self.stages
            if float(s["end"]) < float(s["start"]) - EPS
        ]

    # -------------------------------------------------------------- #
    # latency + blame
    # -------------------------------------------------------------- #
    def ttft_s(self) -> Optional[float]:
        first = self.first_token
        start = self.start
        if first is None or start is None:
            return None
        return max(0.0, first - start)

    def tpot_s(self) -> Optional[float]:
        """Mean inter-token gap after the first token, journey-wide —
        a slow handoff between the prefill leg's first token and the
        decode leg's second shows up here, exactly where the client
        feels it."""
        first = self.first_token
        end = self.end
        if first is None or end is None or self.tokens <= 1:
            return None
        decode_end = max(
            (
                float(s["end"]) for s in self.stages
                if s.get("stage") == "decode"
            ),
            default=end,
        )
        return max(0.0, decode_end - first) / (self.tokens - 1)

    def stage_totals(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for stage in self.stages:
            name = stage.get("stage")
            totals[name] = totals.get(name, 0.0) + max(
                0.0, float(stage["end"]) - float(stage["start"])
            )
        return totals

    def blame(self, kind: str) -> Optional[str]:
        return blame_stage(self.stages, self.first_token, kind)


def _percentile(values: Sequence[float], fraction: float) -> float:
    ordered = sorted(values)
    if not ordered:
        return 0.0
    index = min(len(ordered) - 1, int(round(fraction * (len(ordered) - 1))))
    return ordered[index]


class JourneyLedger:
    """Joins fleet-wide flight artifacts by trace id.

    Thread-safe: the CLI uses it single-threaded, but a live dashboard
    (``top``-style pollers) may feed artifacts from a reader thread
    while another renders.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # trace_id -> Journey  # guarded-by: _lock
        self._journeys: Dict[str, Journey] = {}
        self.artifacts = 0  # guarded-by: _lock
        self.replicas: Dict[str, str] = {}  # guarded-by: _lock

    def add_artifact(self, path: str) -> int:
        """Read one flight JSONL artifact; its ``meta`` record labels
        every journey record with the emitting replica + fleet role
        (older artifacts without the identity stamp fall back to the
        file name). Returns the number of journey records absorbed."""
        from langstream_tpu_torch.runtime import flight

        records = flight.read_artifact(path)
        replica = ""
        role = ""
        for record in records:
            if record.get("kind") == "meta":
                replica = str(record.get("replica") or replica)
                role = str(record.get("fleet_role") or role)
        if not replica:
            replica = os.path.splitext(os.path.basename(path))[0]
        return self.add_records(records, replica=replica, role=role)

    def add_records(
        self,
        records: Iterable[Mapping[str, Any]],
        *,
        replica: str = "",
        role: str = "",
    ) -> int:
        count = 0
        with self._lock:
            if replica:
                self.replicas[replica] = role
            self.artifacts += 1
            for record in records:
                if record.get("kind") != "journey":
                    continue
                trace_id = str(record.get("trace_id") or "")
                if not trace_id:
                    continue
                entry = dict(record)
                entry.setdefault("replica", replica)
                entry.setdefault("fleet_role", role)
                journey = self._journeys.get(trace_id)
                if journey is None:
                    journey = self._journeys[trace_id] = Journey(trace_id)
                journey.add(entry)
                count += 1
        return count

    def journeys(self) -> List[Journey]:
        with self._lock:
            return sorted(
                self._journeys.values(),
                key=lambda j: j.start if j.start is not None else 0.0,
            )

    def get(self, trace_id: str) -> Optional[Journey]:
        with self._lock:
            return self._journeys.get(trace_id)

    # -------------------------------------------------------------- #
    # aggregates
    # -------------------------------------------------------------- #
    def stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-stage duration percentiles across every journey."""
        samples: Dict[str, List[float]] = {}
        for journey in self.journeys():
            for stage in journey.stages:
                samples.setdefault(stage["stage"], []).append(
                    max(
                        0.0,
                        float(stage["end"]) - float(stage["start"]),
                    )
                )
        return {
            name: {
                "count": float(len(values)),
                "p50_s": _percentile(values, 0.50),
                "p95_s": _percentile(values, 0.95),
                "total_s": sum(values),
            }
            for name, values in samples.items()
        }

    def blame_table(
        self,
        *,
        slo_ttft_s: Optional[float] = None,
        slo_tpot_s: Optional[float] = None,
    ) -> Dict[str, Dict[str, int]]:
        """For each TTFT/TPOT-violating journey, the dominant stage —
        aggregated into the blame table the CLI renders."""
        table: Dict[str, Dict[str, int]] = {"ttft": {}, "tpot": {}}
        for journey in self.journeys():
            ttft = journey.ttft_s()
            if slo_ttft_s and ttft is not None and ttft > slo_ttft_s:
                stage = journey.blame("ttft")
                if stage:
                    table["ttft"][stage] = (
                        table["ttft"].get(stage, 0) + 1
                    )
            tpot = journey.tpot_s()
            if slo_tpot_s and tpot is not None and tpot > slo_tpot_s:
                stage = journey.blame("tpot")
                if stage:
                    table["tpot"][stage] = (
                        table["tpot"].get(stage, 0) + 1
                    )
        return table


# ------------------------------------------------------------------ #
# CLI body (``python -m langstream_tpu_torch journey``) + the ab_analyze digest
# ------------------------------------------------------------------ #
def collect_flight_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(
                os.path.join(path, name)
                for name in sorted(os.listdir(path))
                if name.startswith("flight_") and name.endswith(".jsonl")
            )
        elif os.path.isfile(path):
            out.append(path)
    return out


def waterfall_lines(journey: Journey) -> List[str]:
    """One journey rendered as an indented waterfall: each stage's
    offset from journey start, duration, replica, and attributes."""
    start = journey.start or 0.0
    replicas = ">".join(journey.replicas) or "?"
    classes = ",".join(journey.admit_classes)
    header = (
        f"{journey.trace_id}  e2e {journey.e2e_s:.3f}s"
        f"  tokens={journey.tokens}  replicas={replicas}"
    )
    if classes:
        header += f"  admit={classes}"
    missing = journey.missing_stages()
    if missing:
        header += f"  MISSING={','.join(missing)}"
    lines = [header]
    for stage in journey.stages:
        duration = max(
            0.0, float(stage["end"]) - float(stage["start"])
        )
        attrs = {
            k: v for k, v in stage.items()
            if k not in ("stage", "start", "end", "replica")
        }
        extra = (
            "  " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            if attrs else ""
        )
        lines.append(
            f"  {stage['stage']:<16} +{float(stage['start']) - start:8.3f}s"
            f"  {duration:8.3f}s  {stage.get('replica', '')}{extra}"
        )
    return lines


def run_journey(
    paths: Sequence[str],
    *,
    trace_id: Optional[str] = None,
    slo_ttft_ms: float = 0.0,
    slo_tpot_ms: float = 0.0,
    as_json: bool = False,
    waterfalls: int = 3,
) -> List[str]:
    """The CLI body behind ``python -m langstream_tpu_torch journey``: join flight
    artifacts, render waterfalls / per-stage percentiles / SLO blame.
    Returns the lines to print."""
    files = collect_flight_files(paths)
    if not files:
        raise SystemExit(f"no flight artifacts under {list(paths)}")
    ledger = JourneyLedger()
    for path in files:
        ledger.add_artifact(path)
    journeys = ledger.journeys()
    slo_ttft_s = slo_ttft_ms / 1e3 if slo_ttft_ms else None
    slo_tpot_s = slo_tpot_ms / 1e3 if slo_tpot_ms else None
    if trace_id is not None:
        journey = ledger.get(trace_id)
        if journey is None:
            raise SystemExit(
                f"trace id {trace_id!r} not found in {len(files)} "
                f"artifact(s) ({len(journeys)} journeys)"
            )
        journeys = [journey]
    if as_json:
        doc = {
            "artifacts": len(files),
            "journeys": [
                {
                    "trace_id": j.trace_id,
                    "e2e_s": round(j.e2e_s, 6),
                    "ttft_s": j.ttft_s(),
                    "tpot_s": j.tpot_s(),
                    "tokens": j.tokens,
                    "replicas": j.replicas,
                    "admit_classes": j.admit_classes,
                    "coverage": round(j.coverage(), 4),
                    "finished": j.finished,
                    "missing_stages": j.missing_stages(),
                    "stages": j.stages,
                }
                for j in journeys
            ],
            "stage_stats": ledger.stage_stats(),
            "blame": ledger.blame_table(
                slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s
            ),
        }
        return [json.dumps(doc, indent=2)]
    lines = [
        f"{len(journeys)} journey(s) from {len(files)} flight "
        f"artifact(s) across "
        f"{len([r for r in ledger.replicas if r])} replica(s)"
    ]
    if trace_id is not None:
        lines.extend(waterfall_lines(journeys[0]))
    else:
        stats = ledger.stage_stats()
        if stats:
            lines.append("")
            lines.append(
                f"  {'stage':<16} {'count':>6} {'p50':>9} {'p95':>9} "
                f"{'total':>9}"
            )
            for name in STAGES:
                if name not in stats:
                    continue
                entry = stats[name]
                lines.append(
                    f"  {name:<16} {int(entry['count']):>6}"
                    f" {entry['p50_s']:>8.3f}s {entry['p95_s']:>8.3f}s"
                    f" {entry['total_s']:>8.3f}s"
                )
        torn = [j for j in journeys if j.missing_stages()]
        if torn:
            lines.append("")
            lines.append(
                f"  {len(torn)} torn journey(s) "
                "(replica died mid-request; partial stages kept):"
            )
            for journey in torn[:waterfalls]:
                lines.append(
                    f"    {journey.trace_id}  missing="
                    f"{','.join(journey.missing_stages())}"
                )
        # the slowest journeys, rendered as waterfalls
        for journey in sorted(
            journeys, key=lambda j: -j.e2e_s
        )[:max(0, waterfalls)]:
            lines.append("")
            lines.extend(waterfall_lines(journey))
    if slo_ttft_s or slo_tpot_s:
        blame = ledger.blame_table(
            slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s
        )
        lines.append("")
        lines.append("SLO blame (violating requests by dominant stage):")
        for kind in ("ttft", "tpot"):
            for stage, count in sorted(
                blame[kind].items(), key=lambda kv: -kv[1]
            ):
                lines.append(f"  {kind}  {stage:<16} {count}")
        if not blame["ttft"] and not blame["tpot"]:
            lines.append("  no violations")
    return lines


def journey_digest(directory: str) -> Optional[List[str]]:
    """Compact per-stage digest over every flight artifact in a
    directory — the ``tools/ab_analyze.py`` hook. None when no journey
    records exist (pre-ledger artifacts)."""
    files = collect_flight_files([directory])
    if not files:
        return None
    ledger = JourneyLedger()
    total = sum(ledger.add_artifact(path) for path in files)
    if not total:
        return None
    stats = ledger.stage_stats()
    journeys = ledger.journeys()
    crossed = [j for j in journeys if len(j.replicas) > 1]
    lines = [
        f"  journeys: {len(journeys)} across "
        f"{len(ledger.replicas)} replica(s)"
        + (f", {len(crossed)} multi-replica" if crossed else "")
    ]
    for name in STAGES:
        if name not in stats:
            continue
        entry = stats[name]
        lines.append(
            f"    {name:<16} p50 {entry['p50_s'] * 1e3:7.1f} ms  "
            f"p95 {entry['p95_s'] * 1e3:7.1f} ms  "
            f"({int(entry['count'])})"
        )
    return lines

"""Decode-stall watchdog: notice a degraded or wedged engine and capture
evidence automatically, instead of waiting for a human to read a flight
artifact after the fact.

The port's own copy of ``langstream_tpu/runtime/watchdog.py``. Three
detectors over a
:class:`~langstream_tpu_torch.providers.torch_local.engine.DecodeEngine`'s
public counters, which the port's engine keeps under the JAX engine's
names (read-only — the watchdog never touches the data plane):

- **decode degradation** — per-poll decode latency vs a learned EWMA
  baseline, normalized per *accepted token* (the engine's
  ``decode_token_steps`` counter), not per scan step: with speculative
  decoding a step legitimately takes longer but yields 1..k+1 tokens,
  so a per-step baseline would read "enabling --spec-decode" as a
  degradation. The baseline only absorbs healthy samples, so a
  persistent 4× regression (thermal throttling, a neighbour hogging the
  chip, a pathological batch shape) trips instead of normalizing.
- **no progress** — work is waiting (queued/pending requests or active
  slots) but NO dispatch (decode chunk or prefill) completes for
  ``no_progress_s``: a hung dispatch, a deadlocked engine thread, a
  dead device tunnel. The default window is generous (120 s) because a
  first-seen jit variant legitimately blocks the engine thread for the
  whole compile — engines serving big models should precompile, and
  deployments that do can lower the window.
- **KV-pool livelock** (paged layout) — admissions are pending, the
  block pool is effectively exhausted, and no prefill lands for
  ``livelock_s``: every block is referenced by running work and nothing
  is releasing (PR 3's pool-pressure failure mode).

A trip flushes the flight recorder, writes a structured
``watchdog_trip`` flight event, bumps the process-wide
``watchdog_trips_total`` counter (exposed through ``engines_snapshot``
on ``/metrics``), and — rate-limited — starts a ``torch.profiler``
capture (:func:`langstream_tpu_torch.runtime.tracing.capture`) so the
evidence window covers the stall itself. ``escalate_trips`` trips within
``escalate_window_s`` hand the engine to ``on_escalate`` (the
supervisor's restart).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from langstream_tpu_torch.api.metrics import Counter
from langstream_tpu_torch.runtime import flight

logger = logging.getLogger(__name__)

# process-wide trip counter: every live watchdog counts into one series
# (same aggregation shape as the engine gauges)
TRIPS = Counter("watchdog_trips_total")


def trips_total() -> int:
    return TRIPS.value()


class EngineWatchdog:
    """Polls one engine; trip detection is in :meth:`check` so tests can
    drive it with injected clocks (no thread, no sleeps)."""

    def __init__(
        self,
        engine: Any,
        *,
        interval: float = 5.0,
        no_progress_s: float = 120.0,
        degrade_factor: float = 4.0,
        ewma_alpha: float = 0.2,
        min_baseline_chunks: int = 32,
        livelock_s: float = 30.0,
        livelock_free_frac: float = 0.05,
        trip_cooldown_s: float = 120.0,
        capture_profile: bool = True,
        capture_min_interval_s: float = 600.0,
        capture_seconds: float = 3.0,
        profile_dir: Optional[str] = None,
        escalate_trips: int = 3,
        escalate_window_s: float = 600.0,
    ) -> None:
        self.engine = engine
        self.interval = interval
        self.no_progress_s = no_progress_s
        self.degrade_factor = degrade_factor
        self.ewma_alpha = ewma_alpha
        self.min_baseline_chunks = min_baseline_chunks
        self.livelock_s = livelock_s
        self.livelock_free_frac = livelock_free_frac
        self.trip_cooldown_s = trip_cooldown_s
        self.capture_profile = capture_profile
        self.capture_min_interval_s = capture_min_interval_s
        self.capture_seconds = capture_seconds
        self.profile_dir = profile_dir
        # detector state is confined to the watchdog thread (tests
        # drive check() synchronously with no thread running — same
        # single-writer discipline)
        self.trips = 0  # owned-by: _loop
        self.baseline_step_s: Optional[float] = None  # owned-by: _loop
        self._baseline_chunks = 0  # owned-by: _loop
        # (ts, decode_chunks, decode_token_steps, decode_time,
        # prefill_calls) — token_steps is the per-accepted-token
        # normalizer (== decode_steps for a non-speculative engine)
        self._last: Optional[Tuple[float, int, float, float, int]] = None  # owned-by: _loop
        self._stall_anchor: Optional[float] = None  # owned-by: _loop
        self._livelock_anchor: Optional[float] = None  # owned-by: _loop
        self._last_trip: Dict[str, float] = {}  # owned-by: _loop
        self._last_capture: Optional[float] = None  # owned-by: _loop
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # escalation (the supervisor's second detection signal):
        # `escalate_trips` trips within `escalate_window_s` means the
        # engine is not healing on its own — hand it to `on_escalate`
        # (wired by EngineSupervisor to a snapshot/rebuild/resume
        # restart). Evidence-only behavior (flush, profile, counter) is
        # unchanged; with no callback the escalation is a no-op, and the
        # existing LANGSTREAM_WATCHDOG / --no-watchdog opt-out still
        # disables everything. Escalation fires ONCE per window.
        self.escalate_trips = max(1, int(escalate_trips))
        self.escalate_window_s = float(escalate_window_s)
        self.on_escalate: Optional[Any] = None
        self._trip_times: List[float] = []  # owned-by: _loop
        self._escalated_at: Optional[float] = None  # owned-by: _loop

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="engine-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            if self._thread is threading.current_thread():
                # called from our own loop (supervisor escalation tears
                # the old watchdog down from inside on_escalate): the
                # stop flag ends the loop right after this check returns
                self._thread = None
                return
            self._thread.join(timeout=self.interval + 5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if getattr(self.engine, "_crashed", None) is not None:
                # crash evidence is already flushed by the engine loop
                return
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog must never
                logger.exception("watchdog check failed")  # take anything down

    # ------------------------------------------------------------------ #
    # detection
    # ------------------------------------------------------------------ #
    def _work_waiting(self) -> bool:
        engine = self.engine
        if getattr(engine, "_pending", None):
            return True
        queue = getattr(engine, "_queue", None)
        if queue is not None and not queue.empty():
            return True
        return any(slot.active for slot in getattr(engine, "slots", []))

    def check(self, now: Optional[float] = None) -> Optional[str]:
        """One detection pass; returns the trip reason (also after a
        cooldown-suppressed repeat) or None when healthy."""
        now = time.monotonic() if now is None else now
        stats = self.engine.stats
        chunks = stats["decode_chunks"]
        # per-ACCEPTED-TOKEN latency normalizer: a speculative step
        # yields 1..k+1 tokens, so dividing by scan steps would let
        # enabling spec-decode trip a false "degraded" (and, learned
        # spec-first, mask a real one). Engines predating the counter
        # fall back to raw steps (identical for non-speculative decode).
        steps = float(
            stats.get("decode_token_steps") or stats["decode_steps"]
        )
        decode_time = stats["decode_time"]
        prefills = stats["prefill_calls"] + stats["warm_prefill_calls"]
        reason: Optional[str] = None
        details: Dict[str, Any] = {}

        last = self._last
        # ANY completed dispatch is progress — a prefill-heavy backlog
        # (or a first-request jit compile finishing) must not read as a
        # stall just because no decode chunk landed
        progressed = last is not None and (
            chunks > last[1] or prefills > last[4]
        )
        if progressed:
            self._stall_anchor = None
            delta_steps = steps - last[2]
            if delta_steps > 0:
                step_s = max(0.0, decode_time - last[3]) / delta_steps
                if (
                    self.baseline_step_s is not None
                    and self._baseline_chunks >= self.min_baseline_chunks
                    and step_s
                    > self.degrade_factor * self.baseline_step_s
                ):
                    reason = "decode_degraded"
                    details = {
                        "step_ms": round(step_s * 1e3, 3),
                        "baseline_ms": round(
                            self.baseline_step_s * 1e3, 3
                        ),
                        "factor": round(step_s / self.baseline_step_s, 2),
                    }
                    # degraded samples must not poison the baseline
                else:
                    alpha = self.ewma_alpha
                    self.baseline_step_s = (
                        step_s if self.baseline_step_s is None
                        else (1 - alpha) * self.baseline_step_s
                        + alpha * step_s
                    )
                    self._baseline_chunks += chunks - last[1]
        elif self._work_waiting():
            if self._stall_anchor is None:
                self._stall_anchor = now
            elif now - self._stall_anchor >= self.no_progress_s:
                reason = "no_progress"
                details = {
                    "stalled_s": round(now - self._stall_anchor, 1),
                    "queue_depth": len(
                        getattr(self.engine, "_pending", []) or []
                    ),
                    "active_slots": sum(
                        1 for slot in getattr(self.engine, "slots", [])
                        if slot.active
                    ),
                }
        else:
            self._stall_anchor = None

        if reason is None:
            reason, details = self._check_livelock(now, prefills, last)

        self._last = (now, chunks, steps, decode_time, prefills)
        if reason is not None:
            self._trip(reason, details, now)
        return reason

    def _check_livelock(
        self,
        now: float,
        prefills: int,
        last: Optional[Tuple[float, int, int, float, int]],
    ) -> Tuple[Optional[str], Dict[str, Any]]:
        """Paged pool livelock: pending admissions, a near-exhausted
        pool, and no prefill landing across ``livelock_s`` — decode may
        still be making progress, which is exactly why the no-progress
        detector can't see this state."""
        engine = self.engine
        manager = getattr(engine, "kv_manager", None)
        if manager is None or not getattr(engine, "_pending", None):
            self._livelock_anchor = None
            return None, {}
        total = max(1, getattr(engine, "num_blocks", 1))
        free_frac = (total - manager.blocks_in_use) / total
        admitted = last is not None and prefills > last[4]
        if admitted or free_frac > self.livelock_free_frac:
            self._livelock_anchor = None
            return None, {}
        if self._livelock_anchor is None:
            self._livelock_anchor = now
            return None, {}
        if now - self._livelock_anchor < self.livelock_s:
            return None, {}
        return "kv_pool_livelock", {
            "stalled_s": round(now - self._livelock_anchor, 1),
            "queue_depth": len(engine._pending),
            "kv_blocks_in_use": manager.blocks_in_use,
            "kv_blocks_total": total,
        }

    # ------------------------------------------------------------------ #
    # trip
    # ------------------------------------------------------------------ #
    def _trip(
        self, reason: str, details: Dict[str, Any], now: float
    ) -> None:
        previous = self._last_trip.get(reason)
        if previous is not None and now - previous < self.trip_cooldown_s:
            return  # the stall is already reported; don't spam the ring
        self._last_trip[reason] = now
        self.trips += 1
        TRIPS.count()
        logger.warning("watchdog trip: %s %s", reason, details)
        # the flight artifact is the trip's on-disk evidence — flush the
        # ring NOW so the samples leading up to the stall survive even
        # if the process is killed next
        flight.record("watchdog_trip", reason=reason, **details)
        flight.flush()
        if self.capture_profile and (
            self._last_capture is None
            or now - self._last_capture >= self.capture_min_interval_s
        ):
            self._last_capture = now
            thread = threading.Thread(
                target=self._capture, name="watchdog-capture", daemon=True
            )
            thread.start()
        # escalation LAST: the trip's flight evidence is flushed above,
        # so a synchronous supervisor restart (which tears this watchdog
        # down from inside the callback) can't lose it
        self._note_escalation(reason, now)

    def _note_escalation(self, reason: str, now: float) -> None:
        self._trip_times.append(now)
        cutoff = now - self.escalate_window_s
        self._trip_times = [t for t in self._trip_times if t >= cutoff]
        if len(self._trip_times) < self.escalate_trips:
            return
        if (
            self._escalated_at is not None
            and now - self._escalated_at < self.escalate_window_s
        ):
            return  # one escalation per window — the restart is underway
        self._escalated_at = now
        flight.record(
            "watchdog_escalation",
            reason=reason,
            trips=len(self._trip_times),
            window_s=self.escalate_window_s,
        )
        flight.flush()
        callback = self.on_escalate
        if callback is None:
            return
        logger.error(
            "watchdog: %d trips within %.0fs — escalating (%s)",
            len(self._trip_times), self.escalate_window_s, reason,
        )
        try:
            callback(f"watchdog_escalation:{reason}")
        except Exception:  # noqa: BLE001 — escalation failing must not
            logger.exception("watchdog escalation failed")  # kill the loop

    def _capture(self) -> None:
        from langstream_tpu_torch.runtime import tracing

        try:
            path = tracing.capture(self.capture_seconds, base_dir=self.profile_dir)
            logger.warning("watchdog: profiler capture -> %s", path)
            flight.record("watchdog_capture", path=path)
            flight.flush()
        except tracing.ProfileBusyError:
            pass  # another capture, or a supervisor rebuild, holds the profiler
        except Exception:  # noqa: BLE001
            logger.exception("watchdog: profiler capture failed")

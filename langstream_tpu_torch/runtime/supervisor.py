"""Engine supervisor — crash → rebuild → resume, not crash → mass 500.

The port's own copy of ``langstream_tpu/runtime/supervisor.py``. An
:class:`EngineSupervisor` owns one
:class:`~langstream_tpu_torch.providers.torch_local.engine.DecodeEngine`'s
lifecycle:

1. **Detect** — the engine thread dying (``engine.on_crash``) or a
   watchdog escalation (N trips inside a window → :meth:`request_restart`).
2. **Snapshot** — every live session's replay state via
   ``engine.drain_for_recovery()``: prompt ids and the accepted generated
   tokens (with their logprobs), ``SamplingParams`` with the pinned seed,
   the budget consumed. Queued and still-prefilling requests go back
   untouched (no token ever reached their caller).
3. **Release** — the dead engine's device state goes before the
   replacement allocates (``engine.release()``: its stream drained, its
   graphs reset, KV cache, counts and static buffers dropped), so the
   card never holds two KV caches.
4. **Heal** — rebuild through the factory closure (the weights already on
   the card are reused; ``precompile`` captures the step graphs again)
   and re-admit every session as a replay prefill of its own history.
   Sampling keys derive from ``(seed, position)`` and penalty counts are
   restored exactly, so a greedy or seeded session continues **bitwise**
   as the uncrashed oracle; the re-prefilled tokens are billed as
   ``tokens_wasted{crash_replay}``.

While rebuilding, new callers get ``EngineRebuildingError`` (HTTP 503
with ``Retry-After``), in-flight SSE streams pause and resume, and the
recovery leaves ``engine_restarts_total`` / ``sessions_resurrected_total``
/ ``engine_recovery_seconds`` on ``/metrics``, ``engine_recovery`` flight
events and an ``engine.recovery`` trace span.

A restart budget (``max_restarts`` within ``restart_window_s``) stops a
crash-looping engine: past it the supervisor fails the drained waiters
once and goes ``failed``.

It heals Python-level crashes and wedged steps, the failures the fault
points model. A sticky CUDA error (an illegal address, say) poisons the
process's CUDA context; no rebuild in the same process survives it.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import weakref
from typing import Any, Callable, Deque, Dict, List, Optional

from langstream_tpu_torch.api.metrics import Counter, Histogram
from langstream_tpu_torch.runtime import flight, tracing
from langstream_tpu_torch.runtime.threadsafe import stable_list
from langstream_tpu_torch.runtime.tracing import get_tracer

logger = logging.getLogger(__name__)

# process-wide recovery series (same aggregation shape as the engine
# gauges / watchdog trips: every supervisor counts into one family,
# exposed through engines_snapshot on every /metrics surface)
ENGINE_RESTARTS = Counter("engine_restarts_total")
SESSIONS_RESURRECTED = Counter("sessions_resurrected_total")
RECOVERY_SECONDS = Histogram(
    "engine_recovery_seconds",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0, 300.0),
)

_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()


def supervisor_gauges() -> Dict[str, float]:
    """Recovery gauges for ``engines_snapshot``. Empty until the first
    supervisor exists so unsupervised processes export nothing new;
    once one does, the series exist from construction (0 included) —
    rate() alerts need the family BEFORE the first restart, and the
    degraded gauge matters precisely while zero engines are live."""
    # snapshot-tolerant WeakSet read: supervisors register from the
    # crash path (the dying engine thread) while scrape threads iterate
    supervisors = stable_list(_ACTIVE)
    if not supervisors and ENGINE_RESTARTS.value() == 0:
        return {}
    # degraded = actively rebuilding or terminally failed; a cleanly
    # stopped supervisor (process shutdown) is not an incident
    degraded = any(
        s.state in ("rebuilding", "failed") for s in supervisors
    )
    return {
        "engine_restarts_total": float(ENGINE_RESTARTS.value()),
        "sessions_resurrected_total": float(SESSIONS_RESURRECTED.value()),
        "engine_degraded": 1.0 if degraded else 0.0,
    }


def supervisor_histograms() -> Dict[str, Dict[str, float]]:
    snapshot = RECOVERY_SECONDS.snapshot()
    if not _ACTIVE and not snapshot.get("count"):
        return {}
    return {RECOVERY_SECONDS.name: snapshot}


class EngineSupervisor:
    """Owns one engine's lifecycle. ``factory`` builds a fresh, NOT yet
    started engine (capturing config + already-loaded weights, so a
    rebuild never reloads a checkpoint); ``watchdog_factory``
    (optional) builds an
    :class:`~langstream_tpu_torch.runtime.watchdog.EngineWatchdog` for a
    given engine — the supervisor wires its ``on_escalate`` and owns
    its start/stop across rebuilds."""

    def __init__(
        self,
        factory: Callable[[], Any],
        *,
        max_restarts: int = 3,
        restart_window_s: float = 600.0,
        watchdog_factory: Optional[Callable[[Any], Any]] = None,
    ) -> None:
        self.factory = factory
        self.max_restarts = max(0, int(max_restarts))
        self.restart_window_s = float(restart_window_s)
        self.watchdog_factory = watchdog_factory
        # lifecycle state machine: transitions hold the lock; readers
        # (accepting(), heartbeats) take lock-free stale-tolerant
        # snapshots — blocking a 503-availability check behind a
        # multi-second rebuild held under the lock would freeze every
        # handler exactly when fast failure matters
        self.state = "serving"  # guarded-by: _lock (writes)
        self.restarts = 0  # guarded-by: _lock (writes)
        self.last_recovery_s: Optional[float] = None  # guarded-by: _lock (writes)
        self._restart_times: Deque[float] = collections.deque()  # guarded-by: _lock
        self._lock = threading.RLock()
        self.tracer = get_tracer("engine")
        # the engine generation pointer: swapped under the lock by the
        # heal arc; the serving-surface property reads it lock-free (a
        # stale engine is condemned and fails fast on submit)
        self._engine = factory()  # guarded-by: _lock (writes)
        self._engine.on_crash = self._make_crash_hook(self._engine)
        self.watchdog = self._build_watchdog(self._engine)  # guarded-by: _lock (writes)
        self._engine.start()
        if self.watchdog is not None:
            self.watchdog.start()
        _ACTIVE.add(self)

    # ------------------------------------------------------------------ #
    # serving-surface view
    # ------------------------------------------------------------------ #
    @property
    def engine(self) -> Any:
        return self._engine

    def accepting(self) -> bool:
        return self.state == "serving"

    def retry_after(self) -> float:
        """Seconds a 503'd caller should wait before retrying: the last
        observed rebuild time (a fresh supervisor guesses 2 s)."""
        return max(1.0, self.last_recovery_s or 2.0)

    def stop(self) -> None:
        """Clean shutdown (provider close): no resurrection."""
        with self._lock:
            self.state = "stopped"
            watchdog, self.watchdog = self.watchdog, None
            engine = self._engine
        # join the watchdog OUTSIDE the lock: its thread may itself be
        # blocked on the lock inside request_restart
        if watchdog is not None:
            watchdog.stop()
        engine.on_crash = None
        engine.stop()

    # ------------------------------------------------------------------ #
    # detect
    # ------------------------------------------------------------------ #
    def _make_crash_hook(self, engine: Any):
        def hook(error: BaseException) -> None:
            # runs on the dying engine thread, after the crash flag is
            # set and flight evidence flushed — the whole heal arc
            # executes here (the thread was about to exit anyway)
            self._restart(engine, error, f"engine_crash:{type(error).__name__}")

        return hook

    def request_restart(
        self, reason: str, engine: Optional[Any] = None
    ) -> None:
        """Escalation path (watchdog: N trips in a window): the engine
        is wedged or persistently degraded but its thread may still be
        alive — condemn it, give the thread a bounded chance to exit
        cleanly, then run the same snapshot → rebuild → resume arc.

        ``engine`` pins the escalation to the engine the caller was
        watching: a stale watchdog whose escalation lost a race against
        an organic crash+rebuild must NOT condemn the healthy
        replacement (identity-checked under the lock)."""
        with self._lock:
            if engine is None:
                engine = self._engine
            if engine is not self._engine or self.state != "serving":
                return
            # condemn BEFORE stopping: racing submits get the typed
            # rebuilding error (503), never a torn queue. on_crash stays
            # set so a late organic crash of this engine is ignored by
            # identity in _restart rather than failing waiters.
            engine._crashed = RuntimeError(f"supervisor restart: {reason}")
            engine._running = False
        engine._queue.put(None)  # wake an idle loop so the thread exits
        thread = engine._thread
        if thread is not None and thread is not threading.current_thread():
            # a degraded-but-alive thread exits within one iteration; a
            # truly wedged one times out (it is not emitting anyway) and
            # drain_for_recovery's slot neutralization fences it off
            thread.join(timeout=10.0)
        self._restart(engine, RuntimeError(reason), reason)

    # ------------------------------------------------------------------ #
    # heal
    # ------------------------------------------------------------------ #
    def _restart(
        self, engine: Any, error: BaseException, reason: str
    ) -> None:
        with self._lock:
            if engine is not self._engine or self.state in (
                "failed", "stopped",
            ):
                return  # stale hook (already superseded) or terminal
            self.state = "rebuilding"
            started = time.perf_counter()
            started_wall = time.time()
            now = time.monotonic()
            while (
                self._restart_times
                and now - self._restart_times[0] > self.restart_window_s
            ):
                self._restart_times.popleft()
            self._restart_times.append(now)
            over_budget = len(self._restart_times) > self.max_restarts
            requests = engine.drain_for_recovery()
            replayed = sum(1 for r in requests if r.replay_tokens)
            engine.retire()
            old_stats = engine.stats
            # the dead engine's KV cache, graphs and static buffers go
            # BEFORE the factory allocates (its queued work drained first)
            engine.release()
            if self.watchdog is not None:
                self.watchdog.stop()
                self.watchdog = None
            flight.record(
                "engine_recovery",
                phase="begin",
                reason=reason,
                error=repr(error)[:256],
                sessions=len(requests),
                replayed=replayed,
                restart=len(self._restart_times),
            )
            flight.flush()
            if over_budget:
                self.state = "failed"
                # terminal: later submits must surface a plain 500, not
                # an endless retryable 503
                engine.on_crash = None
                logger.error(
                    "supervisor: %d restarts within %.0fs — giving up",
                    len(self._restart_times), self.restart_window_s,
                )
                flight.record(
                    "engine_recovery", phase="gave_up", reason=reason,
                    restarts=len(self._restart_times),
                )
                flight.flush()
                self._fail_requests(requests, RuntimeError(
                    f"engine crashed {len(self._restart_times)} times "
                    f"within {self.restart_window_s:.0f}s "
                    f"(max-restarts {self.max_restarts}); giving up"
                ))
                return
            logger.warning(
                "supervisor: rebuilding engine (%s; %d live sessions, "
                "%d with accepted tokens)",
                reason, len(requests), replayed,
            )
            try:
                # the WHOLE heal arc is covered: a failure anywhere in
                # rebuild / start / resubmit must fail the drained
                # waiters and land in a terminal state — an escaped
                # exception here would leave every caller hanging and
                # the supervisor 503ing forever from "rebuilding".
                # The profiler is held while the factory captures the
                # step graphs: a watchdog capture must not overlap them
                with tracing.PROFILE_LOCK:
                    rebuilt = self.factory()
                # metrics continuity: the replacement inherits the dead
                # engine's cumulative counters so no series resets
                # mid-incident
                rebuilt.absorb_stats(old_stats)
                rebuilt.on_crash = self._make_crash_hook(rebuilt)
                self._engine = rebuilt
                rebuilt.start()
                resurrected = 0
                for request in requests:
                    try:
                        rebuilt.submit(request)
                        resurrected += 1
                    except Exception:  # noqa: BLE001 — one bad resubmit
                        logger.exception(  # must not doom the rest
                            "supervisor: failed to resurrect a session"
                        )
                        self._fail_requests([request], RuntimeError(
                            "session could not be resurrected after an "
                            "engine rebuild"
                        ))
                try:
                    # a broken watchdog must not doom a healthy rebuilt
                    # engine that already carries resurrected sessions —
                    # serve unwatched rather than fail everything
                    self.watchdog = self._build_watchdog(rebuilt)
                    if self.watchdog is not None:
                        self.watchdog.start()
                except Exception:  # noqa: BLE001
                    logger.exception(
                        "supervisor: watchdog rebuild failed; serving "
                        "without a watchdog"
                    )
                    self.watchdog = None
            except Exception as heal_error:  # noqa: BLE001
                self.state = "failed"
                engine.on_crash = None
                broken = self._engine
                if broken is not engine:
                    # a half-initialized replacement is already
                    # installed (start() raised): condemn it so later
                    # submits fail FAST (plain 500) instead of
                    # enqueueing into an engine whose thread never ran
                    broken.on_crash = None
                    if broken._crashed is None:
                        broken._crashed = RuntimeError(
                            "engine rebuild failed"
                        )
                    broken._running = False
                    broken.retire()
                    broken.release()
                logger.exception("supervisor: engine rebuild failed")
                flight.record(
                    "engine_recovery", phase="rebuild_failed",
                    error=repr(heal_error)[:256],
                )
                flight.flush()
                self._fail_requests(requests, RuntimeError(
                    "engine rebuild failed; see logs"
                ) if not isinstance(heal_error, RuntimeError)
                    else heal_error)
                return
            recovery_s = time.perf_counter() - started
            ENGINE_RESTARTS.count()
            SESSIONS_RESURRECTED.count(resurrected)
            RECOVERY_SECONDS.observe(recovery_s)
            self.restarts += 1
            self.last_recovery_s = recovery_s
            self.state = "serving"
        self.tracer.event(
            "engine.recovery",
            recovery_s,
            start_wall=started_wall,
            reason=reason,
            sessions=resurrected,
            replayed=replayed,
        )
        flight.record(
            "engine_recovery",
            phase="complete",
            reason=reason,
            sessions=resurrected,
            replayed=replayed,
            recovery_s=round(recovery_s, 4),
        )
        flight.flush()
        logger.warning(
            "supervisor: engine rebuilt in %.2fs, %d sessions resurrected",
            recovery_s, resurrected,
        )

    def _build_watchdog(self, engine: Any):
        if self.watchdog_factory is None:
            return None
        watchdog = self.watchdog_factory(engine)
        if watchdog is not None:
            # bind the escalation to THIS engine's generation (see
            # request_restart's identity check)
            watchdog.on_escalate = (
                lambda reason, _engine=engine:
                self.request_restart(reason, engine=_engine)
            )
        return watchdog

    @staticmethod
    def _fail_requests(requests: List[Any], error: BaseException) -> None:
        from langstream_tpu_torch.providers.torch_local.engine import fail_request_future

        for request in requests:
            fail_request_future(request, error)

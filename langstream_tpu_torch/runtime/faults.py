"""Deterministic fault injection — chaos you can replay on the CPU.

The port's own copy of ``langstream_tpu/runtime/faults.py`` (the port
imports nothing of the JAX package): the same spec grammar, environment
variables, sha256-derived firing and process-global arrival counters, so
a spec and seed fire at the same arrivals in both packages. Named fault
points are threaded through the engine thread, the dispatch builders and
the paged allocator, armed by a compact spec so the same crash replays in
a test and on the card (``runtime/supervisor.py`` heals it).

Spec grammar (comma-separated, via :func:`configure` or the
``LANGSTREAM_FAULTS`` env var)::

    LANGSTREAM_FAULTS="engine_thread_crash@step=40,dispatch_error@step=7:1.0"
    LANGSTREAM_FAULTS="stuck_step@step=5;dur=45,pool_exhausted@step=3"

    SPEC  := point '@' 'step=' N [':' PROB] (';' KEY '=' VALUE)*

- ``point@step=N``      — fire exactly on the Nth arrival at the point
  (one-shot: a supervisor-rebuilt engine passing the same point again
  does NOT re-fire, because arrival counters are process-global).
- ``point@step=N:P``    — armed from the Nth arrival on; each arrival
  fires with probability P, derived deterministically from
  ``sha256(point, arrival, seed)`` (seed: ``LANGSTREAM_FAULTS_SEED``),
  so a given spec+seed produces the identical fault sequence every run.
- ``;key=value`` params — handler-specific knobs (e.g. ``stuck_step``'s
  ``dur`` sleep seconds).

Fault points wired today (the registry itself is generic — call sites
decide what firing means):

=====================  ==================================================
``engine_thread_crash``  engine device thread dies after the Nth decode
                         chunk is fully emitted (raises
                         :class:`InjectedFault` in the engine loop)
``stuck_step``           engine loop sleeps ``dur`` seconds (default 30)
                         — a wedged dispatch for watchdog/escalation
                         tests without real stalls
``dispatch_error``       a prefill/decode dispatch builder raises
                         :class:`InjectedFault` before dispatching (on
                         the host, before any launch or graph replay)
``pool_exhausted``       the paged block allocator reports an exhausted
                         pool (``allocate`` returns None) — admission
                         backpressure on demand
``host_promote_torn``    a host-tier promotion raises before its H2D
                         scatter (``engine._promote_host_chain``): it
                         aborts before anything publishes and the
                         admission prefills cold
``mirror_follower``      a tp follower's replay raises before the Nth
                         record (``serving/mirror.py``): a rank dying
                         mid-stream, which must fail the leader's next
                         collective within its time limit
=====================  ==================================================

Unarmed (the default) every check is one attribute read — chaos costs
nothing in production. Every firing leaves a ``fault_injected`` flight
record so recovery evidence names its cause.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

ENV_VAR = "LANGSTREAM_FAULTS"
SEED_ENV_VAR = "LANGSTREAM_FAULTS_SEED"


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised unarmed)."""

    def __init__(self, point: str, arrival: int) -> None:
        super().__init__(f"injected fault {point!r} (arrival {arrival})")
        self.point = point
        self.arrival = arrival


class FaultSpec:
    """One armed fault: point name, trigger step, probability, params."""

    __slots__ = ("point", "step", "prob", "params", "fired")

    def __init__(
        self,
        point: str,
        step: int,
        prob: Optional[float] = None,
        params: Optional[Dict[str, str]] = None,
    ) -> None:
        self.point = point
        self.step = max(1, int(step))
        self.prob = prob  # None = one-shot exactly at `step`
        self.params = params or {}
        self.fired = 0

    def should_fire(self, arrival: int, seed: int) -> bool:
        if self.prob is None:
            return arrival == self.step
        if arrival < self.step or self.prob <= 0.0:
            return False
        if self.prob >= 1.0:
            return True
        # deterministic per-(point, arrival, seed) coin: replaying the
        # same spec reproduces the identical fault sequence
        digest = hashlib.sha256(
            f"{self.point}:{arrival}:{seed}".encode()
        ).digest()
        draw = int.from_bytes(digest[:8], "big") / float(1 << 64)
        return draw < self.prob

    def describe(self) -> str:
        spec = f"{self.point}@step={self.step}"
        if self.prob is not None:
            spec += f":{self.prob}"
        for key, value in sorted(self.params.items()):
            spec += f";{key}={value}"
        return spec


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse a comma-separated fault spec string (see module docstring).
    Raises ValueError on malformed entries — a typo'd chaos spec must
    fail the run loudly, not silently test nothing."""
    out: List[FaultSpec] = []
    for entry in (text or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, at, rest = entry.partition("@")
        if not at or not point:
            raise ValueError(f"fault spec {entry!r}: expected point@step=N")
        parts = rest.split(";")
        head = parts[0]
        if not head.startswith("step="):
            raise ValueError(f"fault spec {entry!r}: expected step=N")
        step_text, colon, prob_text = head[len("step="):].partition(":")
        try:
            step = int(step_text)
            prob = float(prob_text) if colon else None
        except ValueError:
            raise ValueError(
                f"fault spec {entry!r}: bad step/probability"
            ) from None
        if prob is not None and not 0.0 <= prob <= 1.0:
            raise ValueError(f"fault spec {entry!r}: probability not in [0,1]")
        params: Dict[str, str] = {}
        for param in parts[1:]:
            key, eq, value = param.partition("=")
            if not eq or not key:
                raise ValueError(f"fault spec {entry!r}: bad param {param!r}")
            params[key.strip()] = value.strip()
        out.append(FaultSpec(point.strip(), step, prob, params))
    return out


class FaultRegistry:
    """Process-global fault points. ``fire()`` counts an arrival and
    returns the triggering :class:`FaultSpec` (or None); ``check()``
    additionally raises :class:`InjectedFault`. Arrival counters are
    monotonic per point for the process lifetime, so a one-shot fault
    consumed by a crashed engine stays consumed across its supervisor
    rebuild."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._arrivals: Dict[str, int] = {}
        self._seed = 0
        self.armed = False  # fast path: one attribute read when off

    def configure(self, text: str, seed: Optional[int] = None) -> None:
        """Arm the registry from a spec string (replaces any previous
        arming; empty string disarms)."""
        specs = parse_spec(text)
        with self._lock:
            self._specs = {}
            for spec in specs:
                self._specs.setdefault(spec.point, []).append(spec)
            if seed is not None:
                self._seed = int(seed)
            self.armed = bool(self._specs)
        if self.armed:
            logger.warning(
                "fault injection ARMED: %s",
                ",".join(s.describe() for s in specs),
            )

    def configure_from_env(self) -> None:
        text = os.environ.get(ENV_VAR, "")
        if text:
            self.configure(
                text, seed=int(os.environ.get(SEED_ENV_VAR, "0") or "0")
            )

    def reset(self) -> None:
        """Disarm and zero every arrival counter (tests)."""
        with self._lock:
            self._specs = {}
            self._arrivals = {}
            self._seed = 0
            self.armed = False

    def describe(self) -> str:
        with self._lock:
            return ",".join(
                spec.describe()
                for specs in self._specs.values()
                for spec in specs
            )

    def fire(self, point: str) -> Optional[FaultSpec]:
        """Count an arrival at ``point``; return the spec that fires (if
        any). The unarmed fast path never takes the lock."""
        if not self.armed:
            return None
        with self._lock:
            arrival = self._arrivals.get(point, 0) + 1
            self._arrivals[point] = arrival
            specs = self._specs.get(point)
            if not specs:
                return None
            for spec in specs:
                if spec.should_fire(arrival, self._seed):
                    spec.fired += 1
                    self._record(spec, arrival)
                    return spec
        return None

    def check(self, point: str) -> None:
        """Arrival + raise :class:`InjectedFault` when a spec fires."""
        if not self.armed:
            return
        spec = self.fire(point)
        if spec is not None:
            raise InjectedFault(point, self._arrivals[point])

    def maybe_sleep(self, point: str, default_s: float = 30.0) -> float:
        """Arrival + sleep when a spec fires (the ``stuck_step`` shape:
        a dispatch that wedges instead of erroring). Returns the slept
        seconds (0.0 = did not fire)."""
        if not self.armed:
            return 0.0
        spec = self.fire(point)
        if spec is None:
            return 0.0
        duration = float(spec.params.get("dur", default_s))
        time.sleep(duration)
        return duration

    def _record(self, spec: FaultSpec, arrival: int) -> None:
        # evidence trail: a chaos run's flight artifact names every
        # injected failure, so a reader of a recovery never has to guess
        # whether a crash was organic
        logger.warning(
            "fault injection FIRING: %s (arrival %d)",
            spec.describe(), arrival,
        )
        from langstream_tpu_torch.runtime import flight

        flight.record(
            "fault_injected",
            point=spec.point,
            arrival=arrival,
            spec=spec.describe(),
        )
        flight.flush()


REGISTRY = FaultRegistry()


def configure(text: str, seed: Optional[int] = None) -> None:
    REGISTRY.configure(text, seed=seed)


def configure_from_env() -> None:
    REGISTRY.configure_from_env()


def reset() -> None:
    REGISTRY.reset()


def armed() -> bool:
    return REGISTRY.armed


def fire(point: str) -> Optional[FaultSpec]:
    return REGISTRY.fire(point)


def check(point: str) -> None:
    REGISTRY.check(point)


def maybe_sleep(point: str, default_s: float = 30.0) -> float:
    return REGISTRY.maybe_sleep(point, default_s)

"""Per-dependency circuit breaker (closed / open / half-open).

No reference counterpart: the reference hammers a dead dependency at
full call rate (go-redis reconnects per command, ``grpc_server.go``
posts every batch) and relies on the caller's error path. A
:class:`CircuitBreaker` turns a failing dependency into a *state*:
after ``failure_threshold`` consecutive failures the breaker opens and
callers fail fast (or degrade) without touching the network; after
``recovery_timeout_s`` one probe call is admitted (half-open) and its
outcome decides between closing and re-opening.

State and transition counters live in the obs metrics registry
(``vep_breaker_state{dep}``, ``vep_breaker_transitions_total{dep,to}``)
so ``/metrics`` exposes them. (The JAX package's watchdog bound on a
breaker stuck open is not ported.)

The clock is injectable so tier-1 tests run sleep-free.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

from ..obs import registry as obs_registry

log = logging.getLogger(__name__)

__all__ = ["BreakerOpen", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class BreakerOpen(RuntimeError):
    """Raised by :meth:`CircuitBreaker.call` when the breaker rejects a call."""

    def __init__(self, name: str, retry_in_s: float):
        super().__init__(f"circuit breaker '{name}' is open (retry in {retry_in_s:.1f}s)")
        self.name = name
        self.retry_in_s = retry_in_s


class CircuitBreaker:
    """Thread-safe three-state breaker guarding one named dependency.

    Instances share the registry metric families; the ``dep`` label
    separates dependencies. ``allow()``/``record_success()``/
    ``record_failure()`` compose with hand-rolled call sites (the bus
    read path degrades instead of raising); ``call(fn)`` wraps the
    common raise-on-open shape.
    """

    def __init__(
        self,
        name: str,
        *,
        failure_threshold: int = 5,
        recovery_timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.recovery_timeout_s = float(recovery_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_at: Optional[float] = None
        #: transition counts by target state, for soak artifacts.
        self.transitions: Dict[str, int] = {}
        self._m_state = obs_registry.gauge(
            "vep_breaker_state",
            "Circuit breaker state (0=closed, 1=open, 2=half_open)",
            ("dep",),
        ).labels(name)
        self._m_trans = obs_registry.counter(
            "vep_breaker_transitions_total",
            "Circuit breaker state transitions",
            ("dep", "to"),
        )
        self._m_state.set(0)

    # -- state machine ----------------------------------------------------

    def _transition(self, to: str, now: float) -> None:
        # Caller holds self._lock.
        if to == self._state:
            return
        level = logging.WARNING if to == OPEN else logging.INFO
        log.log(level, "breaker '%s': %s -> %s", self.name, self._state, to)
        self._state = to
        self.transitions[to] = self.transitions.get(to, 0) + 1
        self._m_state.set(_STATE_CODE[to])
        self._m_trans.labels(self.name, to).inc()
        if to == OPEN:
            self._opened_at = now
            self._probe_at = None
        elif to == CLOSED:
            self._failures = 0
            self._probe_at = None

    def allow(self) -> bool:
        """True if a call may proceed now (admits the half-open probe)."""
        now = self._clock()
        with self._lock:
            if self._state == OPEN:
                if now - self._opened_at >= self.recovery_timeout_s:
                    self._transition(HALF_OPEN, now)
                else:
                    return False
            if self._state == HALF_OPEN:
                # One probe in flight at a time; if the probe's owner died
                # without recording an outcome, re-admit after another
                # recovery window rather than wedging half-open forever.
                if self._probe_at is not None and now - self._probe_at < self.recovery_timeout_s:
                    return False
                self._probe_at = now
                return True
            return True

    def record_success(self) -> None:
        now = self._clock()
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED, now)

    def record_failure(self) -> None:
        now = self._clock()
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN, now)
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._transition(OPEN, now)

    # -- conveniences -----------------------------------------------------

    def call(self, fn: Callable[[], object], *, excluded: Tuple[Type[BaseException], ...] = ()):
        """Run ``fn`` under the breaker; raise :class:`BreakerOpen` if open.

        Exceptions in ``excluded`` count as the dependency *answering*
        (e.g. an HTTP 403): they record success and re-raise.
        """
        if not self.allow():
            with self._lock:
                retry_in = max(
                    0.0, self.recovery_timeout_s - (self._clock() - self._opened_at)
                )
            raise BreakerOpen(self.name, retry_in)
        try:
            out = fn()
        except excluded:
            self.record_success()
            raise
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return out

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def time_in_open_s(self) -> float:
        """Seconds the breaker has currently been open (0 unless open)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._clock() - self._opened_at)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                "failures": self._failures,
                "transitions": dict(self.transitions),
            }

"""Engine overload degradation ladder (counterpart of
``video_edge_ai_proxy_tpu/resilience/ladder.py``; state machine only, the
engine applies the rungs).

Rungs, in escalation order (each includes the previous):

1. ``normal``           -- nothing.
2. ``shed``             -- drop frames older than a staleness bound before
                           dispatch (oldest first, per group).
3. ``bucket_downshift`` -- cap the collector's batch bucket one size down
                           so device programs shrink.
4. ``admission_pause``  -- pause admission for a deterministic half of the
                           streams; the rest keep their latency.

The JAX ladder's ``shed_to_fleet`` rung, armed only when a fleet router
registers, is left out with the router: an engine without one walks
exactly these four rungs there too.

Pressure is ``queue_depth >= depth_threshold`` (drain backpressure),
``tick_lag_s > lag_factor * tick_budget_s`` (tick staleness) or
``slo_burning`` (a sustained multi-window SLO burn, ``obs/slo.py``). The
ladder escalates one rung after ``escalate_after_s`` of continuous
pressure (the timer restarts at each transition, so rung N takes N
windows) and recovers one rung per ``recover_after_s`` pressure-free.
The clock is injectable, so rung tests run on fake time.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from ..obs import registry as obs_registry

log = logging.getLogger("vep.torch.resilience.ladder")

__all__ = ["RUNGS", "DegradationLadder"]

RUNGS = ("normal", "shed", "bucket_downshift", "admission_pause")


class DegradationLadder:
    """Hysteretic escalate/recover state machine over :data:`RUNGS`."""

    def __init__(self, *, escalate_after_s: float = 0.5, recover_after_s: float = 2.0,
                 depth_threshold: int = 2, lag_factor: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.escalate_after_s = float(escalate_after_s)
        self.recover_after_s = float(recover_after_s)
        self.depth_threshold = int(depth_threshold)
        self.lag_factor = float(lag_factor)
        self._clock = clock
        self._lock = threading.Lock()
        self._rung = 0
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        #: transition counts by target rung name.
        self.transitions: Dict[str, int] = {}
        self._m_rung = obs_registry.gauge(
            "vep_ladder_rung",
            "Engine degradation ladder rung (0=normal .. 3=admission_pause)").labels()
        self._m_trans = obs_registry.counter(
            "vep_ladder_transitions_total", "Degradation ladder transitions", ("to",))
        self._m_rung.set(0)

    def _to(self, idx: int) -> None:
        # Caller holds self._lock.
        prev = self._rung
        name = RUNGS[idx]
        log.log(logging.WARNING if idx > prev else logging.INFO,
                "degradation ladder: %s -> %s", RUNGS[prev], name)
        self._rung = idx
        self.transitions[name] = self.transitions.get(name, 0) + 1
        self._m_rung.set(idx)
        self._m_trans.labels(name).inc()

    def observe(self, *, queue_depth: int, tick_lag_s: float, tick_budget_s: float,
                slo_burning: bool = False) -> str:
        """Feed one tick's pressure signals; returns the current rung name."""
        now = self._clock()
        pressure = (queue_depth >= self.depth_threshold
                    or tick_lag_s > self.lag_factor * tick_budget_s
                    or slo_burning)
        with self._lock:
            if pressure:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (now - self._pressure_since >= self.escalate_after_s
                      and self._rung < len(RUNGS) - 1):
                    self._to(self._rung + 1)
                    self._pressure_since = now
            else:
                self._pressure_since = None
                if self._rung > 0:
                    if self._calm_since is None:
                        self._calm_since = now
                    elif now - self._calm_since >= self.recover_after_s:
                        self._to(self._rung - 1)
                        self._calm_since = now
                else:
                    self._calm_since = None
            return RUNGS[self._rung]

    @property
    def rung(self) -> str:
        with self._lock:
            return RUNGS[self._rung]


    def snapshot(self) -> dict:
        """The rung and the transition counts (the server's
        ``/api/v1/router`` and the admin ``RouterState``); no fleet router
        attaches to the port's ladder."""
        with self._lock:
            return {"rung": RUNGS[self._rung], "transitions": dict(self.transitions),
                    "fleet_attached": False}

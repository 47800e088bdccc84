"""Engine overload degradation ladder (counterpart of
``video_edge_ai_proxy_tpu/resilience/ladder.py``; state machine only, the
engine applies the rungs).

Rungs, in escalation order (each includes the previous):

1. ``normal``           -- nothing.
2. ``shed``             -- drop frames older than a staleness bound before
                           dispatch (oldest first, per group).
3. ``shed_to_fleet``    -- ask the fleet router (``serve/router.py``, which
                           scrapes ``vep_ladder_rung``) to move this
                           engine's lowest-priority streams to healthy
                           peers. The engine does what it does at
                           ``shed``; the rung makes horizontal re-placement
                           engage before the local ladder shrinks device
                           programs. Skipped unless a router registered
                           (:meth:`DegradationLadder.register_fleet`): an
                           engine without one walks the other four rungs.
4. ``bucket_downshift`` -- cap the collector's batch bucket one size down
                           so device programs shrink.
5. ``admission_pause``  -- pause admission for a deterministic half of the
                           streams; the rest keep their latency.

Pressure is ``queue_depth >= depth_threshold`` (drain backpressure),
``tick_lag_s > lag_factor * tick_budget_s`` (tick staleness) or
``slo_burning`` (a sustained multi-window SLO burn, ``obs/slo.py``). The
ladder escalates one rung after ``escalate_after_s`` of continuous
pressure (the timer restarts at each transition, so rung N takes N
windows) and recovers one rung per ``recover_after_s`` pressure-free.
Transitions count in ``vep_ladder_rung`` and
``vep_ladder_transitions_total{to}``. With a watchdog, a degraded
excursion is one ``engine_degraded`` episode, logged once. With a decision
journal every transition is an event (``ladder.escalate``/``recover``,
subject ``ladder:engine``) whose trigger is the pressure breakdown and
whose cause is the previous transition, or, for a fresh escalation under
SLO burn, the SLO's ``episode_open``; ``last_transition_seq`` is the
handle the engine's shed excursion links to.

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

RUNGS = ("normal", "shed", "shed_to_fleet", "bucket_downshift", "admission_pause")
_FLEET_IDX = RUNGS.index("shed_to_fleet")


class DegradationLadder:
    """Hysteretic escalate/recover state machine over :data:`RUNGS`."""

    def __init__(self, *, escalate_after_s: float = 0.5, recover_after_s: float = 2.0,
                 depth_threshold: int = 2, lag_factor: float = 3.0,
                 clock: Callable[[], float] = time.monotonic,
                 watchdog=None, journal=None):
        self.escalate_after_s = float(escalate_after_s)
        self.recover_after_s = float(recover_after_s)
        self.depth_threshold = int(depth_threshold)
        self.lag_factor = float(lag_factor)
        self._clock = clock
        self._watchdog = watchdog
        self.journal = journal
        self.last_transition_seq: Optional[int] = None
        self._pressure_detail: Dict = {}
        self._lock = threading.Lock()
        self._rung = 0
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        # The fleet router's hook: None skips shed_to_fleet in the walk.
        self._fleet_cb: Optional[Callable[[bool], None]] = None
        self._fleet_info: Optional[Dict] = None
        #: transition counts by target rung name.
        self.transitions: Dict[str, int] = {}
        self._m_rung = obs_registry.gauge(
            "vep_ladder_rung",
            "Engine degradation ladder rung (0=normal .. 4=admission_pause;"
            " 2=shed_to_fleet only when a fleet router is attached)").labels()
        self._m_trans = obs_registry.counter(
            "vep_ladder_transitions_total", "Degradation ladder transitions", ("to",))
        self._m_rung.set(0)

    def _to(self, idx: int) -> None:
        # Caller holds self._lock.
        prev = self._rung
        name = RUNGS[idx]
        seq = None
        if self.journal is not None:
            trigger = dict(self._pressure_detail)
            trigger["from"] = RUNGS[prev]
            trigger["to"] = name
            if idx > prev:
                action = "escalate"
                cause = self.last_transition_seq if prev != 0 else None
                if cause is None and trigger.get("slo_burning"):
                    # A fresh excursion under SLO burn: the chain roots
                    # at the SLO's episode_open.
                    cause = self.journal.latest_seq(actor="slo", action="episode_open")
            else:
                action = "recover"
                cause = self.last_transition_seq
            seq = self.journal.record("ladder", action, subject=("ladder", "engine"),
                                      trigger=trigger, cause=cause)
            self.last_transition_seq = seq
        log.log(logging.WARNING if idx > prev else logging.INFO,
                "degradation ladder: %s -> %s", RUNGS[prev], name,
                extra={"vep_actor": "ladder", "vep_subject": "ladder:engine",
                       "vep_journal_seq": seq})
        self._rung = idx
        self.transitions[name] = self.transitions.get(name, 0) + 1
        self._m_rung.set(idx)
        self._m_trans.labels(name).inc()

    def _step(self, direction: int) -> int:
        """The next rung index one step in ``direction`` (+1 escalate, -1
        recover), over shed_to_fleet when no router is registered. Caller
        holds self._lock."""
        nxt = self._rung + direction
        if nxt == _FLEET_IDX and self._fleet_cb is None:
            nxt += direction
        return nxt

    def register_fleet(self, callback: Callable[[bool], None],
                       info: Optional[Dict] = None) -> None:
        """Arm the shed_to_fleet rung. ``callback(active)`` fires with True
        on entering the rung and False on leaving it, outside the ladder's
        lock, its exceptions logged; keep it non-blocking. ``info`` shows
        in :meth:`snapshot` (who attached, from where)."""
        with self._lock:
            self._fleet_cb = callback
            self._fleet_info = dict(info or {})

    def unregister_fleet(self) -> None:
        """Disarm shed_to_fleet: the walk is the four-rung one again; a
        ladder at the rung steps over it on its next transition."""
        with self._lock:
            self._fleet_cb = None
            self._fleet_info = None

    @property
    def fleet_info(self) -> Optional[Dict]:
        with self._lock:
            return dict(self._fleet_info) if self._fleet_info is not None else None

    def observe(self, *, queue_depth: int, tick_lag_s: float, tick_budget_s: float,
                slo_burning: bool = False, hbm_pressure: bool = False) -> str:
        """Feed one tick's pressure signals; returns the current rung name.
        ``slo_burning`` (the SLOs' burn verdict) and ``hbm_pressure`` (the
        device-memory plane's, ``obs/hbm.py``: burning, or an OOM forecast
        inside its horizon) are ORed with the queue-level signals, under
        the same hysteresis."""
        now = self._clock()
        pressure = (queue_depth >= self.depth_threshold
                    or tick_lag_s > self.lag_factor * tick_budget_s
                    or slo_burning
                    or hbm_pressure)
        fleet_edge: Optional[bool] = None
        with self._lock:
            # The breakdown a transition this tick journals as its trigger.
            self._pressure_detail = {
                "queue_depth": int(queue_depth),
                "tick_lag_s": round(float(tick_lag_s), 4),
                "tick_budget_s": round(float(tick_budget_s), 4),
                "slo_burning": bool(slo_burning),
                "hbm_pressure": bool(hbm_pressure),
            }
            was_fleet = self._rung == _FLEET_IDX
            if pressure:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                elif (now - self._pressure_since >= self.escalate_after_s
                      and self._rung < len(RUNGS) - 1):
                    self._to(self._step(+1))
                    self._pressure_since = now
            else:
                self._pressure_since = None
                if self._rung > 0:
                    if self._calm_since is None:
                        self._calm_since = now
                    elif now - self._calm_since >= self.recover_after_s:
                        self._to(self._step(-1))
                        self._calm_since = now
                else:
                    self._calm_since = None
            is_fleet = self._rung == _FLEET_IDX
            if is_fleet != was_fleet:
                fleet_edge = is_fleet
            cb = self._fleet_cb
            rung = self._rung
        if fleet_edge is not None and cb is not None:
            try:
                cb(fleet_edge)
            except Exception:  # noqa: BLE001 -- the router's hook must not end ticks
                log.exception("fleet shed callback failed")
        if self._watchdog is not None:
            # One "degraded" episode across the whole excursion, closed
            # when the ladder is back at normal.
            self._watchdog.check("engine_degraded", float(rung), above=0.0,
                                 detail=f"degradation ladder at '{RUNGS[rung]}'")
        return RUNGS[rung]

    @property
    def rung(self) -> str:
        with self._lock:
            return RUNGS[self._rung]

    @property
    def rung_index(self) -> int:
        with self._lock:
            return self._rung

    def snapshot(self) -> dict:
        """The rung, the transition counts and the fleet attachment (the
        server's ``/api/v1/router`` and the admin ``RouterState``)."""
        with self._lock:
            out = {"rung": RUNGS[self._rung], "transitions": dict(self.transitions),
                   "fleet_attached": self._fleet_cb is not None}
            if self._fleet_info is not None:
                out["fleet"] = dict(self._fleet_info)
            return out

"""Device-fault domain of the mesh engine (counterpart of
``video_edge_ai_proxy_tpu/engine/fault.py``, host code, the port's own copy).

Once serving is data-parallel over a mesh of device slots
(``parallel/mesh.py``), one failed or wedged card would zero the whole
member's capacity. This module is the fault domain's bookkeeping:

- :class:`FaultLedger`: frame conservation across a failover. Every frame
  handed to the device pipeline is counted out again as emitted or as a
  reasoned drop, with the fault windows declared, so "nothing was lost
  outside the fault window" is a balance that can be checked.
- :class:`FaultPlane`: the per-dispatch watchdog: hard faults (a step
  error attributed to a slot, by the error's ``fault_shard`` attribute or
  by the slot's device name in its message), stall suspicion (drains
  overrunning ``fault_dispatch_deadline_ms`` on ``fault_hysteresis``
  consecutive batches, attributed by a probe a slot), the pending-failover
  handoff to the tick thread, the ``vep_fault_*`` metric families and the
  ``/api/v1/faults`` snapshot.

The failover itself (survivor mesh, re-pin, counted reset of the sharded
carry state, recapture) runs in ``InferenceEngine._execute_failover`` on
the tick thread. This module imports no torch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..obs import registry as obs_registry


class FaultLedger:
    """Frame-conservation proof for the device-fault domain.

    Balance identity: ``dispatched == emitted + sum(dropped) + lost``
    where ``lost`` is the residual — zero once the pipeline quiesces.
    Drops carry a reason and whether a declared fault window was open;
    ``device_fault`` drops outside any window are loss the failover
    cannot excuse (``lost_outside_window``). Duplicates are detected by
    per-stream sequence monotonicity — the engine keys emissions on
    ``(packet, timestamp_ms)`` so producers that never stamp packet ids
    still order by capture time: re-emitting a key a stream already
    emitted is a duplicate; a key *below* the last one is a producer
    restart rebase (bus rings renumber on re-create — legitimate,
    counted separately, never a duplicate)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.dispatched = 0
        self.emitted = 0
        self.duplicated = 0
        self.rebased = 0
        self.dropped: Dict[str, int] = {}
        self.dropped_outside_window = 0
        self._last_seq: Dict[str, int] = {}
        self._windows: List[dict] = []
        self._open: Optional[dict] = None

    # -- taps (engine tick / drain threads) --

    def note_dispatched(self, n: int) -> None:
        with self._lock:
            self.dispatched += int(n)

    def note_emitted(self, stream: str, seq) -> None:
        with self._lock:
            self.emitted += 1
            last = self._last_seq.get(stream)
            if last is not None:
                if seq == last:
                    self.duplicated += 1
                elif seq < last:
                    self.rebased += 1
            self._last_seq[stream] = seq

    def note_dropped(self, n: int, reason: str) -> None:
        with self._lock:
            self.dropped[reason] = self.dropped.get(reason, 0) + int(n)
            if reason == "device_fault" and self._open is None:
                self.dropped_outside_window += int(n)

    # -- fault windows --

    def open_window(self, reason: str) -> None:
        with self._lock:
            if self._open is None:
                self._open = {"reason": reason, "opened": self._clock(),
                              "closed": None}

    def close_window(self) -> None:
        with self._lock:
            if self._open is not None:
                self._open["closed"] = self._clock()
                self._windows.append(self._open)
                self._open = None

    @property
    def window_open(self) -> bool:
        with self._lock:
            return self._open is not None

    def balance(self) -> dict:
        """The conservation verdict. ``lost`` > 0 means frames entered
        the pipeline and never came out under ANY counted reason — only
        meaningful once in-flight batches have drained (callers quiesce
        first; a live snapshot legitimately shows the drain queue's
        depth here)."""
        with self._lock:
            dropped = dict(self.dropped)
            lost = self.dispatched - self.emitted - sum(dropped.values())
            return {
                "dispatched": self.dispatched,
                "emitted": self.emitted,
                "dropped": dropped,
                "duplicated": self.duplicated,
                "rebased": self.rebased,
                "lost": lost,
                "lost_outside_window": self.dropped_outside_window
                + max(0, lost),
                "windows": [dict(w) for w in self._windows]
                + ([dict(self._open)] if self._open else []),
            }


class FaultPlane:
    """Watchdog state machine + obs surface for the device-fault domain.

    States per engine: healthy -> (hard error | stall suspicion ->
    probe) -> shards pending failover -> failover executed by the tick
    thread -> healthy over the survivor mesh. Detection runs where the
    signal is (errors on the tick thread, deadline overruns on the
    drain thread); the failover handoff is the ``pending`` map, drained
    by the tick thread only — one writer for every mesh mutation."""

    EVENTS_KEEP = 32

    def __init__(self, *, shards: int = 1,
                 deadline_ms: float = 5000.0,
                 hysteresis: int = 2,
                 failover_budget_ms: float = 30000.0,
                 probe_timeout_ms: float = 2000.0,
                 clock=time.monotonic, journal=None):
        self.deadline_ms = float(deadline_ms)
        self.hysteresis = max(1, int(hysteresis))
        self.failover_budget_ms = float(failover_budget_ms)
        self.probe_timeout_ms = float(probe_timeout_ms)
        self.shards = max(1, int(shards))
        self.ledger = FaultLedger(clock=clock)
        self._clock = clock
        # The decision journal: detection and failover are audit events;
        # last_detected_seq is the cause handle the engine links its
        # failover (and the supervisor its device_fault spawn) to.
        self.journal = journal
        self.last_detected_seq: Optional[int] = None
        self._lock = threading.Lock()
        self._overruns = 0              # consecutive drain overruns
        self._suspect_since: Optional[float] = None
        self._pending: Dict[int, str] = {}   # shard -> fault kind
        self._events: deque = deque(maxlen=self.EVENTS_KEEP)
        self.failovers = 0
        # Per-shard stall attribution: None = engine default probe (a
        # tiny device round-trip per shard lead, bounded by
        # probe_timeout_ms); tests and the chaos soak inject their own.
        # Returns the list of faulted shard indices (current numbering).
        self.probe_fn = None
        self._m_detected = obs_registry.counter(
            "vep_fault_detected_total",
            "Device faults detected, by kind", ("kind",))
        self._m_failovers = obs_registry.counter(
            "vep_fault_failovers_total",
            "Survivor-mesh failovers executed, by outcome", ("outcome",))
        self._m_failover_ms = obs_registry.histogram(
            "vep_fault_failover_ms",
            "Failover wall time, detection handoff to survivor mesh "
            "serving (ms)").labels()
        self._m_dropped = obs_registry.counter(
            "vep_fault_dropped_frames_total",
            "Frames dropped by the device-fault domain, by reason",
            ("reason",))
        self._m_evacuated = obs_registry.counter(
            "vep_fault_evacuated_total",
            "Sharded carry-state entries counted-reset at failover",
            ("kind",))
        self._m_shards = obs_registry.gauge(
            "vep_fault_survivor_shards",
            "Mesh shards currently serving (shrinks on failover)"
        ).labels()
        self._m_overruns = obs_registry.counter(
            "vep_fault_deadline_overruns_total",
            "Drain fetches exceeding fault_dispatch_deadline_ms").labels()
        self._m_shards.set(self.shards)

    def configure(self, *, shards: int,
                  shard_devices: Optional[Dict[int, List[str]]] = None
                  ) -> None:
        """Engine wiring at warmup (and after every mesh swap): the live
        shard count and the shard -> device-name attribution map."""
        with self._lock:
            self.shards = max(1, int(shards))
        self._m_shards.set(self.shards)
        if shard_devices is not None:
            self.set_shard_devices(shard_devices)

    # -- detection taps --

    def note_drain(self, device_ms: float) -> None:
        """Drain-thread tap, once per fetched batch: deadline overrun
        hysteresis. Consecutive overruns >= the hysteresis open a stall
        suspicion for the tick thread to probe; one on-time batch closes
        it (a transient contention spike is not a dead card)."""
        with self._lock:
            if device_ms > self.deadline_ms:
                self._overruns += 1
                self._m_overruns.inc()
                if self._overruns >= self.hysteresis \
                        and self._suspect_since is None:
                    self._suspect_since = self._clock()
            else:
                self._overruns = 0
                self._suspect_since = None

    def stall_suspected(self) -> bool:
        with self._lock:
            return self._suspect_since is not None and not self._pending

    def resolve_stall(self, faulted: Sequence[int], tick: int) -> List[int]:
        """Tick-thread probe verdict: ``faulted`` shards (possibly
        empty — generic slowness, not a dead card) resolve the open
        suspicion. Faulted shards become pending and open the ledger's
        fault window at detection time."""
        marked = []
        with self._lock:
            self._suspect_since = None
            self._overruns = 0
            for s in faulted:
                s = int(s)
                if s not in self._pending:
                    self._pending[s] = "stall"
                    marked.append(s)
        for s in marked:
            self._m_detected.labels("stall").inc()
            self._note_detected("stall", s, tick)
        if marked:
            self.ledger.open_window("stall")
        return marked

    def note_error(self, exc: BaseException, tick: int) -> Optional[int]:
        """Tick-thread tap from the dispatch error path: classify a step
        exception. A shard attribution (the error's ``fault_shard``
        attribute, or a device name from the registered shard -> devices
        map appearing in the message) marks the shard pending and opens
        the fault window; unattributable errors stay the tick loop's
        log-and-continue problem."""
        shard = getattr(exc, "fault_shard", None)
        if shard is None:
            text = str(exc)
            for s, names in getattr(self, "_shard_devices", {}).items():
                if any(n and n in text for n in names):
                    shard = s
                    break
        if shard is None:
            return None
        shard = int(shard)
        with self._lock:
            fresh = shard not in self._pending
            # The kind keeps the JAX package's name: the snapshot, the
            # journal and the metric label read alike in both packages.
            self._pending[shard] = "xla_error"
        if fresh:
            self._m_detected.labels("xla_error").inc()
            self._note_detected("xla_error", shard, tick)
            self.ledger.open_window("xla_error")
        return shard

    def set_shard_devices(self, shard_devices: Dict[int, List[str]]) -> None:
        """Register shard -> device-name strings for error attribution
        (re-registered by the engine after every mesh swap)."""
        self._shard_devices = {
            int(s): [str(n) for n in names]
            for s, names in shard_devices.items()
        }

    def _note_detected(self, kind: str, shard: int, tick: int) -> None:
        with self._lock:
            self._events.append({
                "event": "detected", "kind": kind, "shard": shard,
                "tick": tick, "ts": time.time(),
            })
        if self.journal is not None:
            self.last_detected_seq = self.journal.record(
                "fault", "detected", subject=("shard", str(shard)),
                trigger={"kind": kind, "tick": int(tick)})

    # -- failover handoff (tick thread) --

    def pending(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._pending)

    def clear_pending(self, outcome: str = "skipped") -> None:
        """Abandon pending faults without a failover (no survivors, no
        mesh, unattributable) — the window closes so later drops are not
        excused by a failover that never ran."""
        with self._lock:
            had = bool(self._pending)
            pending = dict(self._pending)
            self._pending.clear()
        if had:
            self._m_failovers.labels(outcome).inc()
            self.ledger.close_window()
            if self.journal is not None:
                self.journal.record(
                    "fault", "failover_skipped",
                    subject=("shard", ",".join(
                        str(s) for s in sorted(pending))),
                    trigger={"outcome": outcome,
                             "pending": len(pending)},
                    cause=self.last_detected_seq)

    def note_failover(self, event: dict) -> None:
        """Record a completed failover: closes the fault window, updates
        the survivor-shard gauge, appends the event (served verbatim by
        ``/api/v1/faults`` and read by tools/torch_fault_smoke.py)."""
        with self._lock:
            self._pending.clear()
            self.shards = int(event.get("survivors", self.shards))
            self._events.append(dict(event, event="failover"))
            self.failovers += 1
        self._m_failovers.labels(
            "over_budget" if event.get("over_budget") else "ok").inc()
        self._m_failover_ms.observe(float(event.get("failover_ms", 0.0)))
        self._m_shards.set(self.shards)
        for kind, n in (event.get("evacuated") or {}).items():
            if n:
                self._m_evacuated.labels(str(kind)).inc(int(n))
        self.ledger.close_window()
        if self.journal is not None:
            dead = event.get("shards_dead") or []
            streams = event.get("streams") or {}
            self.journal.record(
                "fault", "failover",
                subject=("shard", ",".join(str(s) for s in dead)),
                trigger={"kinds": ",".join(
                    str(k) for k in (event.get("kinds") or [])) or "unknown",
                    "survivors": int(event.get("survivors", 0)),
                    "failover_ms": round(
                        float(event.get("failover_ms", 0.0)), 1),
                    "repinned": int(streams.get("repinned", 0))},
                cause=self.last_detected_seq)

    def note_dropped(self, n: int, reason: str) -> None:
        """Ledger + metric tap for reasoned frame drops (the lineage
        tracer records the per-frame side separately)."""
        if n <= 0:
            return
        self.ledger.note_dropped(n, reason)
        self._m_dropped.labels(reason).inc(int(n))

    # -- introspection --

    def snapshot(self) -> dict:
        """The ``/api/v1/faults`` document."""
        with self._lock:
            pending = dict(self._pending)
            events = [dict(e) for e in self._events]
            suspect = self._suspect_since is not None
            overruns = self._overruns
            shards = self.shards
            failovers = self.failovers
        return {
            "config": {
                "deadline_ms": self.deadline_ms,
                "hysteresis": self.hysteresis,
                "failover_budget_ms": self.failover_budget_ms,
                "probe_timeout_ms": self.probe_timeout_ms,
            },
            "shards": shards,
            "failovers": failovers,
            "active": bool(pending) or self.ledger.window_open,
            "stall_suspected": suspect,
            "consecutive_overruns": overruns,
            "pending": {str(s): k for s, k in pending.items()},
            "events": events,
            "ledger": self.ledger.balance(),
        }

"""Autoscaling supervisor (counterpart of
``video_edge_ai_proxy_tpu/serve/supervisor.py``): the capacity forecast
closed into member lifecycle (MultiStream, arxiv 2207.06078 economics).

Every rung below this one moves LOAD: the degradation ladder sheds work
inside one member, ``shed_to_fleet`` moves streams across members. This
module is the rung above — it changes the MEMBER SET. One decision pass
per interval over the router's merged fleet health:

- **scale out** — when the fleet-wide saturation forecast (the earliest
  ``time_to_saturation_s`` across serving members: the first member to
  saturate is the first stream-quality casualty, however much headroom
  its peers hold) crosses ``spawn_horizon_s``, spawn a member through
  the injected ``spawner`` and register it with
  :meth:`~.router.StreamRouter.add_member`. The spawned member boots
  against the shared AOT prewarm cache (engine/aot_cache.py) so it
  holds its program set — and takes migrated traffic — within one
  scrape interval instead of a multi-second compile ramp. A
  ``device_fault`` spawn (r22: a member's survivor-mesh failover count
  increased — a chip died and the member serves degraded) ranks above
  every forecast and bypasses the symmetric cooldown: the capacity loss
  already happened, it is not a forecast echo to be damped.
- **scale in** — when every serving member has held
  ``surplus_headroom`` of forecast headroom for ``surplus_hold_s``
  straight (sustained surplus, not a lull between storm waves), retire
  the emptiest member: :meth:`~.router.StreamRouter.remove_member`
  drains each of its streams through the r16 lineage-verified
  migration (reason ``scale_in``) before the member leaves the fleet,
  so the conservation ledger stays balanced across scale-in.
- **flap containment** — min/max member bounds, spawn/retire cooldowns,
  a surplus timer that resets on any breach or lifecycle action, and
  two hard rules: never retire while ANY member is warming (a spawn is
  in flight; load is about to redistribute), and never spawn while one
  is warming (the last decision has not landed yet).

``spawner()`` returns ``(name, base_url)`` for a member it booted (the
replay harness spawns real engine subprocesses; tests script it); with
no spawner the supervisor runs advisory — decisions are recorded and
counted but the member set never changes (the standalone process mode,
where spawning is an operator's deployment system's job).
``retirer(name)`` tears the process down after the drain.

Standard library + obs/serve control-plane imports only, same as the
router; runs standalone via ``python -m
video_edge_ai_proxy_tpu_torch.serve.supervisor`` (advisory) or embedded in
the autoscale soak harness (acting).

Metric families (obs registry, lint-clean under ``lint_exposition``):

- ``vep_supervisor_members`` — members currently under supervision
- ``vep_supervisor_fleet_time_to_saturation_seconds`` — the merged
  forecast driving scale-out (-1 = no member trending to saturation)
- ``vep_supervisor_fleet_min_headroom`` — worst-member forecast
  headroom driving scale-in (-1 = unreported)
- ``vep_supervisor_fleet_time_to_oom_seconds`` — earliest OOM forecast
  across serving members (obs/hbm.py, r21; -1 = no member trending to
  device-memory exhaustion)
- ``vep_supervisor_surplus_held_seconds`` — how long the scale-in
  surplus condition has held (0 while breached)
- ``vep_supervisor_passes_total`` — decision passes
- ``vep_supervisor_spawns_total`` / ``vep_supervisor_retires_total``
- ``vep_supervisor_blocked_total{reason}`` — wanted-but-blocked
  decisions: ``max_members | min_members | cooldown | warming |
  no_spawner | spawn_failed | retire_failed``
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..obs import registry as obs_registry
from ..utils.logging import get_logger

log = get_logger("serve.supervisor")

__all__ = ["FleetSupervisor"]


class FleetSupervisor:
    """Decision loop over a :class:`~.router.StreamRouter`'s fleet.

    Injectable ``clock``/``sleep`` (tests run time-warped), injectable
    ``spawner``/``retirer`` (tests and the soak harness own the member
    processes). The router is REQUIRED — the supervisor never talks to
    members directly; every action goes through the router so placement,
    migration and the conservation ledger stay the single source of
    truth.
    """

    def __init__(
        self,
        router,
        *,
        spawner: Optional[Callable[[], Optional[Tuple[str, str]]]] = None,
        retirer: Optional[Callable[[str], None]] = None,
        min_members: int = 1,
        max_members: int = 4,
        decision_interval_s: float = 2.0,
        spawn_horizon_s: float = 120.0,
        surplus_headroom: float = 0.6,
        surplus_hold_s: float = 30.0,
        spawn_cooldown_s: float = 10.0,
        retire_cooldown_s: float = 30.0,
        name: str = "supervisor0",
        journal=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if min_members < 1 or max_members < min_members:
            raise ValueError(
                f"member bounds must satisfy 1 <= min <= max, got "
                f"[{min_members}, {max_members}]")
        self.name = name
        self.router = router
        # Decision journal (obs/journal.py, r23). Defaults to the
        # router's journal so supervisor spawns and the router
        # migrations they provoke land in ONE causal chain; None keeps
        # the supervisor journal-free.
        self.journal = (journal if journal is not None
                        else getattr(router, "journal", None))
        self._spawner = spawner
        self._retirer = retirer
        self.min_members = int(min_members)
        self.max_members = int(max_members)
        self.decision_interval_s = float(decision_interval_s)
        self.spawn_horizon_s = float(spawn_horizon_s)
        self.surplus_headroom = float(surplus_headroom)
        self.surplus_hold_s = float(surplus_hold_s)
        self.spawn_cooldown_s = float(spawn_cooldown_s)
        self.retire_cooldown_s = float(retire_cooldown_s)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self._last_spawn: Optional[float] = None
        self._last_retire: Optional[float] = None
        self._surplus_since: Optional[float] = None
        # r22 device-fault edge trigger: member -> last seen failover
        # count. A member is first OBSERVED (count recorded, no action),
        # then an INCREASE is one hard-fault edge — one spawn attempt,
        # not one per pass while the count stays elevated.
        self._fault_seen: dict = {}
        # member -> journal seq of its fault observation (the cause the
        # device_fault spawn links to); edge state for blocked events so
        # a sustained block journals ONCE, not once per pass.
        self._fault_obs_seq: dict = {}
        self._last_blocked: Optional[str] = None
        self._last_decision: dict = {}
        self.events: List[dict] = []   # bounded lifecycle history
        self._m_members = obs_registry.gauge(
            "vep_supervisor_members",
            "Members currently under supervision").labels()
        self._m_tts = obs_registry.gauge(
            "vep_supervisor_fleet_time_to_saturation_seconds",
            "Merged fleet saturation forecast driving scale-out (-1 = "
            "no member trending to saturation)").labels()
        self._m_headroom = obs_registry.gauge(
            "vep_supervisor_fleet_min_headroom",
            "Worst-member forecast headroom driving scale-in (-1 = "
            "unreported)").labels()
        self._m_tto = obs_registry.gauge(
            "vep_supervisor_fleet_time_to_oom_seconds",
            "Earliest member OOM forecast driving scale-out (-1 = no "
            "member trending to device-memory exhaustion)").labels()
        self._m_surplus = obs_registry.gauge(
            "vep_supervisor_surplus_held_seconds",
            "How long the scale-in surplus condition has held (0 while "
            "breached)").labels()
        self._m_passes = obs_registry.counter(
            "vep_supervisor_passes_total",
            "Supervisor decision passes").labels()
        self._m_spawns = obs_registry.counter(
            "vep_supervisor_spawns_total",
            "Members spawned (scale-out + min-bound enforcement)"
        ).labels()
        self._m_retires = obs_registry.counter(
            "vep_supervisor_retires_total",
            "Members retired after a drained scale-in").labels()
        self._m_blocked = obs_registry.counter(
            "vep_supervisor_blocked_total",
            "Wanted-but-blocked lifecycle decisions", ("reason",))
        self._m_members.set(len(router.clients))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.decision_interval_s + 10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_pass()
            except Exception:  # noqa: BLE001 — control loop must survive
                log.exception("supervisor pass failed")
            self._stop.wait(self.decision_interval_s)

    # -- the decision pass -------------------------------------------------

    def _fleet_view(self, health: List[dict]) -> dict:
        """Fold per-member rows into the two scale signals. Serving =
        up, fresh, not warming (a warming member neither relieves
        pressure yet nor counts toward surplus)."""
        serving = [r for r in health
                   if r.get("up") and not r.get("stale")
                   and not r.get("warming")]
        warming = [r["instance"] for r in health if r.get("warming")]
        tts = [r["time_to_saturation_s"] for r in serving
               if r.get("time_to_saturation_s") is not None]
        head = [r["headroom"] for r in serving
                if r.get("headroom") is not None]
        tto = [r["time_to_oom_s"] for r in serving
               if r.get("time_to_oom_s") is not None]
        return {
            "members": len(self.router.clients),
            "serving": [r["instance"] for r in serving],
            "warming": warming,
            # Earliest forecast saturation anywhere IS the fleet's: that
            # member's streams degrade first regardless of peer headroom,
            # and shed_to_fleet only helps while peers have room.
            "fleet_tts_s": min(tts) if tts else None,
            # Same earliest-casualty logic for device memory (r21,
            # obs/hbm.py): the first member whose allocator fails takes
            # every stream on it down at once.
            "fleet_tto_s": min(tto) if tto else None,
            # Scale-in wants the WORST member comfortable, and every
            # serving member reporting (one capacity-less member means
            # the surplus claim is unverifiable — hold).
            "min_headroom": (min(head)
                             if head and len(head) == len(serving)
                             else None),
        }

    def _record(self, event: dict) -> None:
        event = dict(event)
        event["pass"] = self.passes
        self.events.append(event)
        del self.events[:-64]

    def _view_trigger(self, reason: str, view: dict) -> dict:
        """Quantitative trigger for a journal event: the fleet-view
        signals the decision was made on (None signals omitted)."""
        trig = {"reason": reason, "members": int(view["members"])}
        for key in ("fleet_tts_s", "fleet_tto_s", "min_headroom"):
            if view.get(key) is not None:
                trig[key] = round(float(view[key]), 3)
        return trig

    def _journal_blocked(self, blocked: str, wanted: str,
                         view: dict) -> None:
        """Edge-triggered blocked event: a wanted-but-blocked decision
        journals once per distinct (wanted, blocked) state, not once
        per pass while the pressure persists."""
        key = f"{wanted}/{blocked}"
        if self.journal is None or self._last_blocked == key:
            self._last_blocked = key
            return
        self._last_blocked = key
        trig = self._view_trigger(wanted, view)
        trig["blocked"] = blocked
        self.journal.record("supervisor", "blocked",
                            subject=("fleet", self.name), trigger=trig)

    def _try_spawn(self, reason: str, view: dict,
                   ignore_cooldown: bool = False,
                   cause: Optional[int] = None) -> Optional[str]:
        """Bound/cooldown-gated spawn; returns the new member name.
        ``ignore_cooldown`` (device_fault only): a chip death is a step
        LOSS of capacity, not a forecast echo — the symmetric cooldown
        that damps forecast ping-pong must not delay replacing it. The
        bound and warming gates still hold (capacity already booting
        covers the loss; the fleet ceiling is the operator's)."""
        now = self._clock()
        if view["members"] >= self.max_members:
            self._m_blocked.labels("max_members").inc()
            self._journal_blocked("max_members", reason, view)
            return None
        if view["warming"]:
            # A spawn is already in flight; judging pressure again
            # before it serves would double-provision every burn.
            self._m_blocked.labels("warming").inc()
            self._journal_blocked("warming", reason, view)
            return None
        # Cooldown counts from the last lifecycle action in EITHER
        # direction: a retire's drain migrations step up the survivors'
        # utilization, and the capacity forecast reads that slope as
        # burn for a fast-window's worth of seconds — spawning on that
        # echo would ping-pong the member set.
        if not ignore_cooldown:
            for stamp in (self._last_spawn, self._last_retire):
                if stamp is not None \
                        and now - stamp < self.spawn_cooldown_s:
                    self._m_blocked.labels("cooldown").inc()
                    self._journal_blocked("cooldown", reason, view)
                    return None
        if self._spawner is None:
            # Advisory mode: the decision is recorded (and visible in
            # the snapshot/metrics) but nothing boots.
            self._m_blocked.labels("no_spawner").inc()
            self._record({"action": "spawn_advised", "reason": reason})
            self._last_blocked = None
            if self.journal is not None:
                self.journal.record(
                    "supervisor", "spawn_advised",
                    subject=("fleet", self.name),
                    trigger=self._view_trigger(reason, view), cause=cause)
            return None
        try:
            spawned = self._spawner()
        except Exception:  # noqa: BLE001 — spawner owns process mgmt
            log.exception("spawner failed (%s)", reason)
            spawned = None
        if not spawned:
            self._m_blocked.labels("spawn_failed").inc()
            self._journal_blocked("spawn_failed", reason, view)
            return None
        member, base_url = spawned
        self.router.add_member(member, base_url)
        self._last_spawn = now
        self._surplus_since = None   # fresh capacity: surplus restarts
        self._m_spawns.inc()
        self._last_blocked = None
        # The decision view rides along: "scale-out beat the burn" is
        # checkable from the event alone (was headroom still positive
        # when the spawn landed?).
        self._record({"action": "spawn", "reason": reason,
                      "member": member, "url": base_url,
                      "fleet_tts_s": view["fleet_tts_s"],
                      "fleet_tto_s": view.get("fleet_tto_s"),
                      "min_headroom": view["min_headroom"]})
        seq = None
        if self.journal is not None:
            seq = self.journal.record(
                "supervisor", "spawn", subject=("member", member),
                trigger=self._view_trigger(reason, view), cause=cause)
        log.info("spawned %s (%s): %s", member, reason, base_url,
                 extra={"vep_actor": "supervisor",
                        "vep_subject": f"member:{member}",
                        "vep_journal_seq": seq})
        return member

    def _try_retire(self, view: dict, health: List[dict]) -> Optional[str]:
        """Cooldown-gated retire of the emptiest serving member."""
        now = self._clock()
        if view["members"] <= self.min_members:
            self._m_blocked.labels("min_members").inc()
            self._journal_blocked("min_members", "headroom_surplus", view)
            return None
        if view["warming"]:
            self._m_blocked.labels("warming").inc()
            self._journal_blocked("warming", "headroom_surplus", view)
            return None
        for stamp in (self._last_spawn, self._last_retire):
            if stamp is not None and now - stamp < self.retire_cooldown_s:
                self._m_blocked.labels("cooldown").inc()
                self._journal_blocked("cooldown", "headroom_surplus",
                                      view)
                return None
        # Emptiest serving member; ties retire the lexically LAST name
        # (later spawns sort last under the harness's m<N> naming, so
        # the fleet contracts newest-first — deterministic either way).
        candidates = sorted(
            ((len(self.router.streams_on(r["instance"])), r["instance"])
             for r in health
             if r["instance"] in view["serving"]),
            key=lambda t: (t[0], t[1]),
        )
        if not candidates:
            return None
        count = candidates[0][0]
        victim = max(n for c, n in candidates if c == count)
        # Journal the retire decision BEFORE the drain so every
        # scale_in migration it provokes links back to it as cause;
        # a failed drain records retire_failed in the same chain.
        seq = None
        if self.journal is not None:
            trig = self._view_trigger("headroom_surplus", view)
            trig["streams"] = count
            seq = self.journal.record(
                "supervisor", "retire", subject=("member", victim),
                trigger=trig)
        try:
            moved = self.router.remove_member(victim, cause=seq)
        except Exception as e:  # noqa: BLE001 — drain failed; retry
            log.exception("retire drain of %s failed", victim)
            self._m_blocked.labels("retire_failed").inc()
            if self.journal is not None:
                self.journal.record(
                    "supervisor", "retire_failed",
                    subject=("member", victim),
                    trigger={"error": type(e).__name__}, cause=seq)
            return None
        if self._retirer is not None:
            try:
                self._retirer(victim)
            except Exception:  # noqa: BLE001 — process teardown is
                log.exception("retirer failed for %s", victim)  # advisory
        self._last_retire = now
        self._surplus_since = None
        self._m_retires.inc()
        self._last_blocked = None
        self._record({"action": "retire", "member": victim,
                      "drained_streams": moved,
                      "min_headroom": view["min_headroom"]})
        log.info("retired %s (%d streams drained)", victim, len(moved),
                 extra={"vep_actor": "supervisor",
                        "vep_subject": f"member:{victim}",
                        "vep_journal_seq": seq})
        return victim

    def run_pass(self) -> dict:
        """One observe→decide→act pass (the background loop calls this
        every ``decision_interval_s``; tests call it directly). At most
        ONE lifecycle action per pass: the next pass re-reads the fleet
        the action just changed instead of acting twice on a stale
        view."""
        with self._lock:
            health = self.router.fleet.health()
            now = self._clock()
            view = self._fleet_view(health)
            decision = dict(view, action="hold", reason="")
            # Surplus timer: runs only while EVERY serving member holds
            # the bar; any breach (or unreported capacity) resets it.
            if (view["min_headroom"] is not None
                    and view["min_headroom"] >= self.surplus_headroom
                    and not view["warming"]):
                if self._surplus_since is None:
                    self._surplus_since = now
            else:
                self._surplus_since = None
            held = (now - self._surplus_since
                    if self._surplus_since is not None else 0.0)
            # Bounds first (an operator shrinking max_members mid-storm
            # still converges), then the forecast, then surplus.
            # Device-fault edge detection (r22): an increase in a
            # member's failover count since the last pass means a chip
            # died and the member now serves degraded on fewer shards.
            # First observation of a member only records its count —
            # a supervisor attached to a fleet with failover history
            # must not spawn for faults it never witnessed.
            faulted: List[str] = []
            for r in health:
                n = r.get("device_fault_failovers")
                if n is None:
                    continue
                inst = r["instance"]
                prev = self._fault_seen.get(inst)
                if prev is None:
                    self._fault_seen[inst] = int(n)
                elif int(n) > prev:
                    faulted.append(inst)
                    if self.journal is not None:
                        # Observation event: the member's fault counter
                        # stepped — the cause the device_fault spawn
                        # links back to (member-local fault events live
                        # in the MEMBER's journal, not this one).
                        self._fault_obs_seq[inst] = self.journal.record(
                            "supervisor", "fault_observed",
                            subject=("member", inst),
                            trigger={"failovers": int(n),
                                     "prev": int(prev)})
            if view["members"] < self.min_members:
                decision["reason"] = "min_bound"
                member = self._try_spawn("min_bound", view)
                decision["action"] = "spawn" if member else "hold"
                decision["member"] = member
            elif faulted:
                # Ranked above every forecast: the capacity loss already
                # HAPPENED. Hard faults bypass the symmetric cooldown
                # (ignore_cooldown) — soft forecasts keep respecting it.
                decision["reason"] = "device_fault"
                decision["fault_members"] = faulted
                member = self._try_spawn(
                    "device_fault", view, ignore_cooldown=True,
                    cause=self._fault_obs_seq.get(faulted[0]))
                decision["action"] = "spawn" if member else "hold"
                decision["member"] = member
                # Edge consumed after ONE attempt, spawned or blocked:
                # re-attempting every pass while the count stays
                # elevated would hammer max_members/warming forever.
                for r in health:
                    n = r.get("device_fault_failovers")
                    if n is not None and r["instance"] in faulted:
                        self._fault_seen[r["instance"]] = int(n)
            elif (view["fleet_tts_s"] is not None
                    and view["fleet_tts_s"] <= self.spawn_horizon_s):
                decision["reason"] = "saturation_forecast"
                member = self._try_spawn("saturation_forecast", view)
                decision["action"] = "spawn" if member else "hold"
                decision["member"] = member
            elif (view["fleet_tto_s"] is not None
                    and view["fleet_tto_s"] <= self.spawn_horizon_s):
                # Device memory trending to exhaustion is as terminal as
                # compute saturation — an OOM kills every stream on the
                # member at once — but slower-moving, so it ranks after
                # the saturation forecast (r21, obs/hbm.py).
                decision["reason"] = "oom_forecast"
                member = self._try_spawn("oom_forecast", view)
                decision["action"] = "spawn" if member else "hold"
                decision["member"] = member
            elif held >= self.surplus_hold_s:
                decision["reason"] = "headroom_surplus"
                victim = self._try_retire(view, health)
                decision["action"] = "retire" if victim else "hold"
                decision["member"] = victim
            decision["surplus_held_s"] = round(held, 3)
            self.passes += 1
            self._last_decision = decision
            self._m_passes.inc()
            self._m_members.set(len(self.router.clients))
            self._m_tts.set(view["fleet_tts_s"]
                            if view["fleet_tts_s"] is not None else -1.0)
            self._m_headroom.set(view["min_headroom"]
                                 if view["min_headroom"] is not None
                                 else -1.0)
            self._m_tto.set(view["fleet_tto_s"]
                            if view["fleet_tto_s"] is not None else -1.0)
            self._m_surplus.set(held)
            return decision

    # -- admin -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/api/v1/supervisor`` body."""
        with self._lock:
            health = self.router.fleet.health()
            now = self._clock()
            return {
                "name": self.name,
                "passes": self.passes,
                "bounds": {"min": self.min_members,
                           "max": self.max_members},
                "decision_interval_s": self.decision_interval_s,
                "spawn_horizon_s": self.spawn_horizon_s,
                "surplus": {
                    "headroom": self.surplus_headroom,
                    "hold_s": self.surplus_hold_s,
                    "held_s": round(now - self._surplus_since, 3)
                    if self._surplus_since is not None else 0.0,
                },
                "cooldowns": {
                    "spawn_s": self.spawn_cooldown_s,
                    "retire_s": self.retire_cooldown_s,
                    "since_spawn_s": round(now - self._last_spawn, 3)
                    if self._last_spawn is not None else None,
                    "since_retire_s": round(now - self._last_retire, 3)
                    if self._last_retire is not None else None,
                },
                "acting": self._spawner is not None,
                "members": {
                    r["instance"]: {
                        "up": r.get("up"),
                        "warming": bool(r.get("warming")),
                        "streams": len(self.router.streams_on(
                            r["instance"])),
                        "headroom": r.get("headroom"),
                        "time_to_saturation_s":
                            r.get("time_to_saturation_s"),
                        "time_to_oom_s": r.get("time_to_oom_s"),
                        "hbm_headroom_bytes": r.get("hbm_headroom_bytes"),
                        "healthy": r.get("healthy"),
                    }
                    for r in health
                },
                "last_decision": dict(self._last_decision),
                "events": [dict(e) for e in self.events],
            }


def main(argv=None) -> None:
    """Standalone supervisor process (advisory mode): a router + the
    decision loop + an admin plane on stdlib http.server. With no
    spawner the member set never changes — decisions land in
    ``/api/v1/supervisor`` (``last_decision``/``events``) and the
    ``vep_supervisor_*`` families for the deployment system to act on.

    Usage::

      python -m video_edge_ai_proxy_tpu_torch.serve.supervisor \\
          --members m0=http://h0:8080 m1=http://h1:8080 --port 9092
    """
    import argparse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .router import StreamRouter

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--members", nargs="+", required=True,
                    help="member specs: name=http://host:port")
    ap.add_argument("--port", type=int, default=9092)
    ap.add_argument("--scrape-interval", type=float, default=1.0)
    ap.add_argument("--decision-interval", type=float, default=2.0)
    ap.add_argument("--min-members", type=int, default=1)
    ap.add_argument("--max-members", type=int, default=4)
    ap.add_argument("--spawn-horizon", type=float, default=120.0)
    ap.add_argument("--surplus-headroom", type=float, default=0.6)
    ap.add_argument("--surplus-hold", type=float, default=30.0)
    args = ap.parse_args(argv)

    router = StreamRouter(
        args.members, scrape_interval_s=args.scrape_interval)
    router.run_pass()
    router.attach()
    router.start()
    sup = FleetSupervisor(
        router,
        min_members=args.min_members, max_members=args.max_members,
        decision_interval_s=args.decision_interval,
        spawn_horizon_s=args.spawn_horizon,
        surplus_headroom=args.surplus_headroom,
        surplus_hold_s=args.surplus_hold)
    sup.start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?")[0]
            if path == "/metrics":
                body = obs_registry.render().encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/api/v1/supervisor":
                body = json.dumps(sup.snapshot()).encode()
                ctype = "application/json"
            elif path == "/api/v1/router/stats":
                body = json.dumps(router.snapshot()).encode()
                ctype = "application/json"
            elif path == "/api/v1/router/ledger":
                body = json.dumps(router.ledger.balance()).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    srv = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(json.dumps({"supervisor": sup.name, "port": srv.server_port,
                      "members": sorted(router.clients),
                      "acting": False}), flush=True)
    try:
        srv.serve_forever()
    finally:
        sup.stop()
        router.stop()
        router.detach()


if __name__ == "__main__":
    main()

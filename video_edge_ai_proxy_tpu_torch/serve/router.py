"""Fleet router (counterpart of ``video_edge_ai_proxy_tpu/serve/router.py``):
consistent-hash stream placement + burn-driven, lineage-verified live
migration (MultiStream, arxiv 2207.06078).

No reference counterpart: the reference is strictly single-box (one
Chrysalis server owns every camera). This module turns N independent
engine members into ONE serving fleet:

- :class:`HashRing` — consistent hashing with health-weighted virtual
  nodes. Placement is stable (adding/removing a member moves ~1/N of
  the keys, tests/test_router.py pins it) and deterministic (FNV-1a over
  ``member#vnode`` / stream name, no process-seeded hashing).
- :class:`MemberClient` — stdlib-urllib REST client for one member
  (start/stop stream, stats), guarded by a per-member
  :class:`~..resilience.breaker.CircuitBreaker` so a dead member fails
  fast instead of stalling every control-loop pass on timeouts.
- :class:`MigrationLedger` — the frame-conservation proof plane. The
  result consumer feeds every delivery (``stream, member, packet``,
  joined by the r14 on-wire ``trace_id``); :meth:`MigrationLedger.balance`
  then proves exactly-once across a handoff: delivered packets form a
  gap-free run from the first delivery with zero duplicates, even when
  delivery crossed members mid-stream.
- :class:`StreamRouter` — the control loop. One pass per scrape
  interval: scrape members (its private
  :class:`~..obs.fleet.FleetAggregator`), rebuild the ring from the
  hysteresis-banded ``healthy`` verdicts (obs/fleet.py r16), fail over
  every stream of a DEAD member immediately, and gracefully migrate
  streams OFF a member whose SLO burn fired or whose ladder reached
  ``shed_to_fleet`` (resilience/ladder.py r16 rung — armed on the member
  by :meth:`StreamRouter.attach`, so a burning engine sheds streams to
  healthy peers BEFORE its local ladder starts shrinking device
  programs).

Migration is an explicit drain→cutover→resume protocol:

1. **drain** — stop ingest on the source member and poll its per-stream
   stats until the emitted-frame counter is static (everything the
   worker published has left the engine);
2. **cutover** — flip the stream's placement in the router registry;
3. **resume** — start the stream on the destination with the replay
   cursor (``replay://...&start=<next>``) from ``cursor_source`` — the
   result plane's next-undelivered index — so recorded packet ids (and
   the content-derived trace ids minted from them) stay disjoint across
   the handoff. A killed member skips (1): the replay-from-cursor resume
   re-produces exactly the frames that died in flight.

Importable without torch by design (stdlib + the pure
Python obs/resilience planes only): the router runs as its own process
(``python -m video_edge_ai_proxy_tpu_torch.serve.router``) in front of the
members' gRPC/REST, never inside one.

Metric families (obs registry, lint-clean under ``lint_exposition``):

- ``vep_router_members`` / ``vep_router_ring_members`` — configured vs
  currently-placeable members
- ``vep_router_streams`` — streams under management
- ``vep_router_placements_total{member}`` — stream starts per member
- ``vep_router_migrations_total{reason}`` — reason in
  ``member_dead | shed_to_fleet | slo_burn | unhealthy | scale_in |
  admin`` (``scale_in`` = supervisor retire drain, r19)
- ``vep_router_migration_failures_total{reason}``
- ``vep_router_replace_seconds`` — detection→resumed latency histogram
  (the kill-one-member acceptance number)
- ``vep_router_ledger_lost_frames`` / ``vep_router_ledger_dup_frames``
  — conservation ledger verdict gauges (0/0 = balanced)
"""

from __future__ import annotations

import bisect
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlencode, urlsplit, urlunsplit

from ..obs import registry as obs_registry
from ..obs.fleet import FleetAggregator
from ..resilience.breaker import BreakerOpen, CircuitBreaker
from ..resilience.ladder import RUNGS
from ..resilience.policy import Deadline, RetryPolicy

log = logging.getLogger("vep.torch.serve.router")

__all__ = ["HashRing", "MemberClient", "MigrationLedger", "StreamRouter"]

_FLEET_RUNG_IDX = RUNGS.index("shed_to_fleet")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _hash64(key: str) -> int:
    """FNV-1a 64-bit + a splitmix64 finalizer — deterministic across
    processes/runs (placement must not depend on PYTHONHASHSEED), same
    hash family as the r14 on-wire trace ids. The avalanche pass
    matters: raw FNV of short keys ("m0#17") clusters on the ring and
    can starve a member of its share entirely."""
    h = _FNV_OFFSET
    for b in key.encode():
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


class HashRing:
    """Consistent-hash ring with weighted virtual nodes.

    ``weight`` scales a member's virtual-node count (``base_vnodes`` at
    weight 1.0, floor 1) — the router quantizes health scores into
    coarse weight bands before calling :meth:`set_weight`, so only a
    banded health change (not per-scrape score noise) re-shapes the
    ring. Not thread-safe; the router mutates it under its own lock.
    """

    def __init__(self, base_vnodes: int = 64):
        if base_vnodes < 1:
            raise ValueError(f"base_vnodes must be >= 1, got {base_vnodes}")
        self.base_vnodes = int(base_vnodes)
        self._weights: Dict[str, float] = {}
        self._points: List[Tuple[int, str]] = []   # sorted (hash, member)
        self._hashes: List[int] = []

    def _rebuild(self) -> None:
        points: List[Tuple[int, str]] = []
        for member, weight in self._weights.items():
            vnodes = max(1, int(round(self.base_vnodes * weight)))
            for i in range(vnodes):
                points.append((_hash64(f"{member}#{i}"), member))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def add(self, member: str, weight: float = 1.0) -> None:
        self._weights[member] = max(0.0, float(weight))
        self._rebuild()

    def remove(self, member: str) -> None:
        if self._weights.pop(member, None) is not None:
            self._rebuild()

    def set_weight(self, member: str, weight: float) -> None:
        if member not in self._weights:
            raise KeyError(member)
        if self._weights[member] != weight:
            self._weights[member] = max(0.0, float(weight))
            self._rebuild()

    @property
    def members(self) -> List[str]:
        return sorted(self._weights)

    def place(self, key: str, exclude: Sequence[str] = ()) -> Optional[str]:
        """First member clockwise from hash(key), skipping ``exclude``
        (the failover path excludes the member being evacuated). None
        when the ring is empty or fully excluded."""
        if not self._points:
            return None
        excluded = set(exclude)
        start = bisect.bisect_right(self._hashes, _hash64(key))
        n = len(self._points)
        seen: set = set()
        for off in range(n):
            member = self._points[(start + off) % n][1]
            if member in excluded or member in seen:
                seen.add(member)
                continue
            return member
        return None


class MemberClient:
    """REST client for one engine member: retry + deadline + breaker.

    Every call goes through the member's :class:`CircuitBreaker`
    (``vep_breaker_state{dep="router_<member>"}``): after
    ``failure_threshold`` consecutive faults the router fails fast on
    this member — no connect timeouts burning the control loop — and a
    half-open probe re-admits it. On top of the breaker (r22 satellite),
    each control call runs under a :class:`RetryPolicy` bounded by a
    per-call :class:`Deadline`: transient faults (a member mid-restart,
    one dropped SYN) retry with decorrelated jitter instead of failing a
    whole router/supervisor pass, while a HUNG member's REST socket —
    the failure mode a plain retry loop makes worse — can never stall
    the pass past ``deadline_s``, because every attempt's socket timeout
    is clamped to the remaining budget and the loop refuses to sleep
    past it. An open breaker aborts immediately (no retrying into a
    circuit that exists to fail fast). Counters:
    ``vep_router_member_retries_total{member}`` and
    ``vep_router_member_deadline_exceeded_total{member}``.
    """

    def __init__(self, name: str, base_url: str, *, timeout_s: float = 2.0,
                 failure_threshold: int = 3, recovery_timeout_s: float = 5.0,
                 retry_attempts: int = 2, deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        # Whole-call budget: attempts + backoff sleeps all fit inside it.
        # Default leaves room for one full-timeout attempt, a jittered
        # backoff, and a clamped second attempt — still well inside one
        # scrape interval times a small member count.
        self.deadline_s = (float(deadline_s) if deadline_s is not None
                           else 2.5 * self.timeout_s)
        self._clock = clock
        self.retry = RetryPolicy(
            max_attempts=max(1, int(retry_attempts)),
            base_s=0.05, cap_s=0.5, clock=clock, sleep=sleep)
        self.breaker = CircuitBreaker(
            f"router_{name}", failure_threshold=failure_threshold,
            recovery_timeout_s=recovery_timeout_s, clock=clock)
        self._m_retries = obs_registry.counter(
            "vep_router_member_retries_total",
            "Member control-call attempts retried after a transient "
            "fault", ("member",))
        self._m_deadline = obs_registry.counter(
            "vep_router_member_deadline_exceeded_total",
            "Member control calls that exhausted their deadline budget "
            "(hung REST socket contained)", ("member",))

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> bytes:
        import urllib.request

        deadline = Deadline.after(self.deadline_s, clock=self._clock)

        def call() -> bytes:
            # Per-attempt socket timeout clamped to the remaining
            # budget: a wedged accept()/read() on the member side times
            # out when the BUDGET says so, not timeout_s later.
            deadline.check(f"{self.name} {method} {path}")
            req = urllib.request.Request(
                self.base_url + path, method=method,
                data=json.dumps(body).encode() if body is not None else None,
                headers={"Content-Type": "application/json"}
                if body is not None else {})
            timeout = max(0.001, deadline.clamp(self.timeout_s))
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.read()

        def on_retry(_attempt: int, _exc: BaseException,
                     _delay: float) -> None:
            self._m_retries.labels(self.name).inc()

        try:
            return self.retry.run(
                lambda: self.breaker.call(call),
                abort_on=(BreakerOpen,), deadline=deadline,
                on_retry=on_retry)
        except BreakerOpen:
            raise
        except BaseException:
            if deadline.expired:
                self._m_deadline.labels(self.name).inc()
            raise

    # -- member control surface (serve/rest_api.py routes) --

    def start_stream(self, name: str, rtsp_endpoint: str,
                     inference_model: str = "",
                     annotation_policy: str = "") -> None:
        self._request("POST", "/api/v1/process", {
            "name": name, "rtsp_endpoint": rtsp_endpoint,
            "inference_model": inference_model,
            "annotation_policy": annotation_policy,
        })

    def stop_stream(self, name: str) -> None:
        self._request("DELETE", f"/api/v1/process/{name}")

    def stats(self) -> dict:
        return json.loads(self._request("GET", "/api/v1/stats"))

    def stream_frames(self, name: str) -> Optional[int]:
        """Emitted-frame count for one stream from /api/v1/stats (the
        drain probe: static count == engine drained), None when the
        engine no longer reports it."""
        eng = (self.stats() or {}).get("engine") or {}
        st = (eng.get("streams") or {}).get(name)
        return int(st["frames"]) if st and "frames" in st else None

    def attach_router(self, router: str, url: str = "") -> dict:
        return json.loads(self._request(
            "POST", "/api/v1/router/attach",
            {"router": router, "url": url}))

    def detach_router(self) -> None:
        self._request("POST", "/api/v1/router/detach")


class MigrationLedger:
    """Frame-conservation accounting across live migrations.

    The result consumer calls :meth:`note_delivery` for every
    ``InferenceResult`` it receives (``frame_packet`` + the member it
    subscribed; the on-wire ``trace_id`` ties the entry back to the
    frame's worker→bus→engine lineage). :meth:`balance` then checks the
    exactly-once invariant per stream: delivered packet ids form one
    gap-free run from the FIRST delivered packet (warmup ramp before
    first delivery is placement, not migration, and is excluded by
    construction) with no packet delivered twice — across however many
    members served the stream. There is deliberately no way to restart
    the window: r16 soaks carried a post-warmup ``reset()`` because a
    member compiling in-tick overwrote frames (latest-frame-wins), and
    the r19 AOT prewarm cache removed that ramp — conservation holds
    from the very first frame.

    Storage is interval-compacted (r21): the healthy
    steady state — one member delivering packets in order — folds into a
    single ``[lo, hi, member]`` run per stream instead of one dict entry
    per packet, so a day-long 30 fps stream costs three ints, not 2.6 M
    entries, and ledger memory is O(streams + migrations + gaps +
    duplicates) at the item-4 1,000-stream scale. Runs are contiguous,
    single-member and duplicate-free by construction; packets delivered
    more than once move to a ``packet -> [members...]`` side table with
    their exact owner lists (splitting the run they came from), so
    :meth:`balance` reports the same rows — including duplicate owner
    attribution — as the per-packet design, and the loss count comes
    from interval gaps, never from scanning ``range(lo, hi + 1)``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # stream -> sorted disjoint [lo, hi, member] runs (contiguous,
        # duplicate-free, single-member spans).
        self._runs: Dict[str, List[list]] = {}
        # stream -> packet -> [members...] for packets delivered more
        # than once (always len >= 2; exact delivery-order owner lists).
        self._multi: Dict[str, Dict[int, List[str]]] = {}
        self.migrations: List[dict] = []
        self._m_lost = obs_registry.gauge(
            "vep_router_ledger_lost_frames",
            "Conservation ledger: packets missing inside the delivered "
            "range, all streams (0 = balanced)").labels()
        self._m_dup = obs_registry.gauge(
            "vep_router_ledger_dup_frames",
            "Conservation ledger: packets delivered more than once, all "
            "streams (0 = balanced)").labels()

    @staticmethod
    def _run_before(runs: List[list], p: int) -> int:
        """Index of the last run with lo <= p (-1 when none): the only
        run that can contain p, and the left neighbor for inserts."""
        lo_i, hi_i = 0, len(runs)
        while lo_i < hi_i:
            mid = (lo_i + hi_i) // 2
            if runs[mid][0] <= p:
                lo_i = mid + 1
            else:
                hi_i = mid
        return lo_i - 1

    def note_delivery(self, stream: str, member: str, packet: int,
                      trace_id: int = 0) -> None:
        with self._lock:
            p = int(packet)
            multi = self._multi.setdefault(stream, {})
            owners = multi.get(p)
            if owners is not None:
                owners.append(member)       # 3rd+ delivery of a known dup
                return
            runs = self._runs.setdefault(stream, [])
            i = self._run_before(runs, p)
            if i >= 0 and runs[i][1] >= p:
                # Second delivery of a run-held packet: split the run
                # around it and move it to the side table with its exact
                # owner list (original run member first).
                rlo, rhi, rm = runs[i]
                pieces = []
                if p > rlo:
                    pieces.append([rlo, p - 1, rm])
                if p < rhi:
                    pieces.append([p + 1, rhi, rm])
                runs[i:i + 1] = pieces
                multi[p] = [rm, member]
                return
            prev = runs[i] if i >= 0 else None
            nxt = runs[i + 1] if i + 1 < len(runs) else None
            if prev is not None and prev[2] == member and prev[1] == p - 1:
                prev[1] = p
                if (nxt is not None and nxt[2] == member
                        and nxt[0] == p + 1):
                    prev[1] = nxt[1]        # filled the gap between two
                    del runs[i + 1]         # same-member runs: one run now
            elif nxt is not None and nxt[2] == member and nxt[0] == p + 1:
                nxt[0] = p
            else:
                runs.insert(i + 1, [p, p, member])

    def record_migration(self, entry: dict) -> None:
        with self._lock:
            self.migrations.append(dict(entry))

    def next_cursor(self, stream: str) -> Optional[int]:
        """Next undelivered packet index (max delivered + 1) — the
        resume cursor for a replay-backed stream. None before any
        delivery."""
        with self._lock:
            runs = self._runs.get(stream) or []
            multi = self._multi.get(stream) or {}
            if not runs and not multi:
                return None
            top = runs[-1][1] if runs else None
            if multi:
                m_top = max(multi)
                top = m_top if top is None else max(top, m_top)
            return top + 1

    def balance(self, stream: Optional[str] = None) -> dict:
        """Conservation verdict. ``stream`` None checks every stream.
        ``balanced`` is True iff zero lost AND zero duplicated."""
        with self._lock:
            streams = ([stream] if stream is not None
                       else sorted(set(self._runs) | set(self._multi)))
            rows = []
            total_lost = total_dup = 0
            for s in streams:
                runs = self._runs.get(s) or []
                multi = self._multi.get(s) or {}
                if not runs and not multi:
                    rows.append({"stream": s, "delivered": 0,
                                 "lost": 0, "duplicated": 0})
                    continue
                # Disjoint coverage: runs, plus the dup singletons (a
                # packet lives in exactly one of the two structures).
                intervals = sorted(
                    [(r[0], r[1]) for r in runs]
                    + [(p, p) for p in multi])
                lo = intervals[0][0]
                hi = max(b for _, b in intervals)
                delivered = (sum(r[1] - r[0] + 1 for r in runs)
                             + len(multi))
                missing: List[int] = []
                lost = 0
                cur = lo           # first covered point
                for a, b in intervals:
                    if a > cur + 1:
                        gap = a - cur - 1
                        lost += gap
                        if len(missing) < 20:
                            missing.extend(range(
                                cur + 1,
                                min(a, cur + 1 + (20 - len(missing)))))
                    cur = max(cur, b)
                dups = {p: list(o) for p, o in multi.items()}
                members = sorted(
                    {r[2] for r in runs}
                    | {m for o in multi.values() for m in o})
                duplicated = sum(len(o) - 1 for o in multi.values())
                total_lost += lost
                total_dup += duplicated
                rows.append({
                    "stream": s, "delivered": delivered,
                    "range": [lo, hi], "members": members,
                    "lost": lost, "missing": missing,
                    "duplicated": duplicated,
                    "dup_examples": dict(sorted(dups.items())[:5]),
                })
        self._m_lost.set(total_lost)
        self._m_dup.set(total_dup)
        return {"balanced": total_lost == 0 and total_dup == 0,
                "lost": total_lost, "duplicated": total_dup,
                "streams": rows}


class StreamRouter:
    """Consistent-hash placement + health-driven re-placement over N
    engine members.

    ``members``: ``"name=http://host:port"`` specs (FleetAggregator
    syntax). ``cursor_source(stream)`` returns the next-undelivered
    packet index for a replay-backed stream (defaults to the router's
    own ledger when deliveries are fed to it; None disables cursor
    resume — live sources re-attach at "now", at-least-once).
    ``client_factory`` is injectable for tests (scripted members, no
    sockets). The clock is injectable so migration tests run sleep-free.
    """

    def __init__(
        self,
        members: Sequence[str],
        *,
        scrape_interval_s: float = 1.0,
        base_vnodes: int = 64,
        max_moves_per_pass: int = 2,
        min_healthy_age_s: float = 0.0,
        drain_timeout_s: float = 8.0,
        drain_poll_s: float = 0.25,
        admit_saturation_horizon_s: float = 60.0,
        admit_oom_horizon_s: float = 60.0,
        ema_alpha: float = 0.4,
        healthy_above: float = 0.7,
        unhealthy_below: float = 0.4,
        cursor_source: Optional[Callable[[str], Optional[int]]] = None,
        client_factory: Optional[Callable[[str, str], MemberClient]] = None,
        fleet: Optional[FleetAggregator] = None,
        name: str = "router0",
        journal=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.name = name
        # Decision journal (obs/journal.py, r23): placements, admission
        # rejections and migrations record WHY they happened, with cause
        # links back to the router's own dead/shedding observations. None
        # (the default) keeps the router journal-free.
        self.journal = journal
        self._clock = clock
        self._sleep = sleep
        self.scrape_interval_s = float(scrape_interval_s)
        self.max_moves_per_pass = int(max_moves_per_pass)
        self.min_healthy_age_s = float(min_healthy_age_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.drain_poll_s = float(drain_poll_s)
        # r18: a member whose capacity forecast says it saturates within
        # this horizon takes NO new admissions while any alternative
        # exists (obs/capacity.py time_to_saturation_s).
        self.admit_saturation_horizon_s = float(admit_saturation_horizon_s)
        # r21: the byte-side twin — a member out of HBM headroom, or
        # forecast to OOM within this horizon (obs/hbm.py
        # time_to_oom_s), takes no new admissions even when its TIME
        # headroom is still positive.
        self.admit_oom_horizon_s = float(admit_oom_horizon_s)
        self.fleet = fleet or FleetAggregator(
            members, scrape_interval_s=scrape_interval_s,
            ema_alpha=ema_alpha, healthy_above=healthy_above,
            unhealthy_below=unhealthy_below)
        self._client_factory = client_factory or (
            lambda n, url: MemberClient(n, url, clock=clock))
        self.clients: Dict[str, MemberClient] = {
            m.name: self._client_factory(m.name, m.base_url)
            for m in self.fleet._members}
        self.ring = HashRing(base_vnodes=base_vnodes)
        self.ledger = MigrationLedger()
        self._cursor_source = cursor_source or self.ledger.next_cursor
        self._lock = threading.RLock()
        # stream -> {url, model, policy, priority, member, placed_at,
        #            migrations}
        self._streams: Dict[str, dict] = {}
        self._evacuated: Dict[str, float] = {}   # member -> detect time
        # Journal seqs of the router's own observation events, keyed by
        # member: the cause links for the migrations they provoke.
        self._evac_seq: Dict[str, int] = {}      # member_dead detection
        self._shed_seq: Dict[str, int] = {}      # shedding observation
        # Members mid-drain (remove_member): excluded from the ring, from
        # _refresh_ring re-adds, and from migration targets until the
        # drain completes (member gone) or aborts (flag cleared, member
        # serves again). The drain itself runs outside the lock — HTTP
        # migrations take seconds — so the flag is what holds the "no NEW
        # placements on a draining member" invariant across passes.
        self._draining: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.passes = 0
        self.last_replace_s: Optional[float] = None
        self._m_members = obs_registry.gauge(
            "vep_router_members", "Configured fleet members").labels()
        self._m_ring = obs_registry.gauge(
            "vep_router_ring_members",
            "Members currently in the placement ring (healthy, breaker "
            "closed)").labels()
        self._m_streams = obs_registry.gauge(
            "vep_router_streams", "Streams under router management"
        ).labels()
        self._m_placements = obs_registry.counter(
            "vep_router_placements_total",
            "Stream starts issued per member", ("member",))
        self._m_migrations = obs_registry.counter(
            "vep_router_migrations_total",
            "Completed live migrations by trigger", ("reason",))
        self._m_mig_fail = obs_registry.counter(
            "vep_router_migration_failures_total",
            "Migrations that failed (stream left unplaced or on source)",
            ("reason",))
        self._m_replace = obs_registry.histogram(
            "vep_router_replace_seconds",
            "Detection-to-resumed latency of a re-placement").labels()
        self._m_members.set(len(self.clients))
        self._m_streams.set(0)

    # -- lifecycle ---------------------------------------------------------

    def attach(self) -> Dict[str, Optional[str]]:
        """Arm the shed_to_fleet rung on every reachable member (POST
        /api/v1/router/attach). Members without an engine/ladder answer
        400 — recorded, not fatal (a member booted engine-less can still
        take streams; it just never *requests* shedding)."""
        out: Dict[str, Optional[str]] = {}
        for name, client in sorted(self.clients.items()):
            try:
                client.attach_router(self.name, "")
                out[name] = None
            except Exception as e:  # noqa: BLE001 — per-member fault
                out[name] = f"{type(e).__name__}: {e}"
        return out

    def detach(self) -> None:
        for client in self.clients.values():
            try:
                client.detach_router()
            except Exception:  # noqa: BLE001
                pass

    # -- membership (r19 supervisor hooks) ---------------------------------

    def add_member(self, name: str, base_url: str) -> None:
        """Register a freshly spawned member. It enters the placement
        ring on a later pass, once its scrape reads healthy AND its
        prewarm program set completed (the fleet's ``warming`` state
        holds it out until then). shed_to_fleet is armed immediately —
        like attach(), a 400 from an engine-less member is not fatal."""
        with self._lock:
            if name in self.clients:
                raise ValueError(f"member {name!r} already registered")
            self.fleet.add_member(f"{name}={base_url}")
            self.clients[name] = self._client_factory(name, base_url)
            self._m_members.set(len(self.clients))
        try:
            self.clients[name].attach_router(self.name, "")
        except Exception:  # noqa: BLE001 — member may lack a ladder
            pass

    def remove_member(self, name: str,
                      cause: Optional[int] = None) -> List[str]:
        """Drain and deregister a member (the supervisor's scale-in
        path). Every stream it still owns is migrated off gracefully
        (``reason="scale_in"`` — the r16 drain→cutover→resume protocol,
        so the conservation ledger stays balanced); only then does the
        member leave the ring/fleet/client set. Returns the streams that
        were moved. A migration failure leaves the stream on the member
        and aborts the removal (the next supervisor pass retries) rather
        than orphaning a stream record whose client is gone."""
        with self._lock:
            if name not in self.clients:
                return []
            # Drain flag BEFORE the ring removal: the member stays in
            # fleet/clients (and scrapes ok) for the seconds the HTTP
            # migrations below take, so without the flag a concurrent
            # _refresh_ring would re-add it and add_stream could place
            # NEW streams on it — placements the one-shot snapshot
            # below would miss and clients.pop would orphan.
            self._draining.add(name)
            if name in self.ring.members:
                self.ring.remove(name)
                self._m_ring.set(len(self.ring.members))
        moved: List[str] = []
        try:
            # Re-snapshot until empty: a migration already in flight when
            # the flag went up may still land a stream on the victim.
            while True:
                pending = [s for s in self.streams_on(name)
                           if s not in moved]
                if not pending:
                    break
                for stream in pending:
                    if self.migrate(stream, reason="scale_in",
                                    graceful=True, cause=cause) is None:
                        raise RuntimeError(
                            f"scale_in drain of {stream!r} off {name!r} "
                            "failed; member left registered for retry")
                    moved.append(stream)
        except BaseException:
            # Abort: the member keeps serving (retire_failed retry path)
            # — clear the flag or it would be ring-banned forever.
            with self._lock:
                self._draining.discard(name)
            raise
        try:
            self.clients[name].detach_router()
        except Exception:  # noqa: BLE001 — member may already be gone
            pass
        with self._lock:
            self.fleet.remove_member(name)
            self.clients.pop(name, None)
            self._draining.discard(name)
            self._evacuated.pop(name, None)
            self._evac_seq.pop(name, None)
            self._shed_seq.pop(name, None)
            self._m_members.set(len(self.clients))
        return moved

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="stream-router", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.drain_timeout_s + 5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_pass()
            except Exception:  # noqa: BLE001 — control loop must survive
                log.exception("router pass failed")
            self._stop.wait(self.scrape_interval_s)

    # -- placement ---------------------------------------------------------

    def _refresh_ring(self, health: List[dict]) -> None:
        """Rebuild ring membership/weights from the hysteresis-banded
        health view. Weight = score_ema quantized to quarter bands, so
        only a banded change re-shapes the ring (flap containment on top
        of the aggregator's own hysteresis)."""
        with self._lock:
            current = set(self.ring.members)
            for row in health:
                member = row["instance"]
                client = self.clients.get(member)
                if client is None:
                    continue   # add/remove_member race; next pass settles
                ok = (row["up"] and not row["stale"]
                      # r19: a warming member (spawned, prewarm program
                      # set incomplete) is alive and scoring but takes
                      # no placements until its compiles land. A member
                      # mid-drain (remove_member) scrapes ok too and
                      # must equally stay out.
                      and not row.get("warming")
                      and member not in self._draining
                      and row.get("healthy", True) is not False
                      and client.breaker.state != "open")
                if ok and self.min_healthy_age_s > 0.0:
                    age = row.get("healthy_since_s")
                    if age is not None and age < self.min_healthy_age_s \
                            and member not in current:
                        ok = False   # too fresh to take traffic
                ema = row.get("score_ema")
                band = (max(1.0, round((ema if ema is not None else 1.0)
                                       * 4) ) / 4.0)
                if ok and member not in current:
                    self.ring.add(member, band)
                elif ok:
                    self.ring.set_weight(member, band)
                elif member in current:
                    self.ring.remove(member)
            self._m_ring.set(len(self.ring.members))

    def add_stream(self, name: str, rtsp_endpoint: str, *,
                   priority: int = 0, inference_model: str = "",
                   annotation_policy: str = "") -> str:
        """Place a new stream on the ring and start it there. Returns
        the member name. Raises RuntimeError when no member is
        placeable."""
        with self._lock:
            if name in self._streams:
                raise ValueError(f"stream {name!r} already routed")
            member = self.ring.place(name)
            if member is None:
                if self.journal is not None:
                    self.journal.record(
                        "router", "admission_rejected",
                        subject=("stream", name),
                        trigger={"reason": "ring_empty",
                                 "members": len(self.clients)})
                raise RuntimeError(
                    "no placeable member (ring empty — all members dead, "
                    "unhealthy, or breaker-open)")
            self.clients[member].start_stream(
                name, rtsp_endpoint, inference_model, annotation_policy)
            self._streams[name] = {
                "url": rtsp_endpoint, "model": inference_model,
                "policy": annotation_policy, "priority": int(priority),
                "member": member, "placed_at": self._clock(),
                "migrations": 0,
            }
            self._m_placements.labels(member).inc()
            self._m_streams.set(len(self._streams))
        if self.journal is not None:
            self.journal.record(
                "router", "place", subject=("stream", name),
                trigger={"member": member, "policy": "hash_ring"})
        return member

    def _pick_admission(self, name: str,
                        candidates: List[dict]) -> Optional[str]:
        """Admission target among placeable health rows (r18 policy).

        Tiered, deterministic:

        1. **Headroom** — rows reporting the capacity plane rank by
           (-headroom, -score_ema, instance): forecast remaining
           capacity first, historical health as tie-break, lexical
           member name as the final tie-break so equal-headroom ties
           never depend on dict/scrape order. A member forecast to
           saturate within ``admit_saturation_horizon_s`` (or already
           out of headroom) is excluded while ANY unsaturated
           capacity-reporting member exists; when every reporter is
           saturated the least-bad one still beats blind hashing.
           Memory is a second dimension of the same filter (r21): a row
           reporting the HBM plane with zero byte-headroom, or an OOM
           forecast within ``admit_oom_horizon_s``, is memory-unsafe
           and excluded even when its TIME headroom is positive — time
           and bytes are independent ways to be full.
        2. **score_ema** — no capacity reporters (pre-r18 fleet): max
           EMA health score, instance-name tie-break (the satellite
           determinism fix — the old scan kept first-seen on ties).
        3. **Hash ring** — nothing scored at all: consistent-hash
           placement (add_stream's path), itself deterministic in the
           stream name.
        """
        scored = [r for r in candidates if r.get("headroom") is not None]
        if scored:
            horizon = self.admit_saturation_horizon_s
            oom_horizon = self.admit_oom_horizon_s

            def memory_unsafe(r: dict) -> bool:
                if not r.get("hbm"):
                    return False    # memory-blind member: time decides
                hb = r.get("hbm_headroom_bytes")
                if hb is not None and hb <= 0:
                    return True
                tto = r.get("time_to_oom_s")
                return tto is not None and tto <= oom_horizon

            safe = [
                r for r in scored
                if r["headroom"] > 0.0
                and not (r.get("time_to_saturation_s") is not None
                         and r["time_to_saturation_s"] <= horizon)
                and not memory_unsafe(r)
            ]
            pool = safe or scored
            pool.sort(key=lambda r: (
                -r["headroom"],
                -(r["score_ema"] if r.get("score_ema") is not None
                  else -1.0),
                r["instance"]))
            return pool[0]["instance"]
        ema = [r for r in candidates if r.get("score_ema") is not None]
        if ema:
            ema.sort(key=lambda r: (-r["score_ema"], r["instance"]))
            return ema[0]["instance"]
        return self.ring.place(name)

    def admit(self, name: str, rtsp_endpoint: str, *,
              priority: int = 0, inference_model: str = "",
              annotation_policy: str = "") -> str:
        """Headroom-aware admission: place a NEW stream on the member
        with the most *remaining* capacity at attach time — placement
        only, existing streams never move (that is run_pass's job).
        Members reporting the r18 capacity plane rank by forecast
        headroom (saturation-forecast members take zero admissions while
        an alternative exists); a capacity-less fleet degrades to max
        score_ema, and with no scored candidates at all to the
        consistent-hash placement (add_stream's path), so admission is
        never worse than hashing. Every tier tie-breaks
        deterministically (see _pick_admission). Raises like add_stream
        when nothing is placeable."""
        health = self.fleet.health()
        with self._lock:
            if name in self._streams:
                raise ValueError(f"stream {name!r} already routed")
            members = set(self.ring.members)
            candidates = []
            for row in health:
                member = row.get("instance")
                if member not in members:
                    continue
                if not row.get("up") or row.get("stale"):
                    continue
                if row.get("healthy", True) is False:
                    continue
                client = self.clients.get(member)
                if client is not None and client.breaker.state == "open":
                    continue
                candidates.append(row)
            member = self._pick_admission(name, candidates)
            if member is None:
                if self.journal is not None:
                    self.journal.record(
                        "router", "admission_rejected",
                        subject=("stream", name),
                        trigger={"reason": "ring_empty",
                                 "members": len(self.clients)})
                raise RuntimeError(
                    "no placeable member (ring empty — all members dead, "
                    "unhealthy, or breaker-open)")
            row = next((r for r in candidates
                        if r.get("instance") == member), None)
            self.clients[member].start_stream(
                name, rtsp_endpoint, inference_model, annotation_policy)
            self._streams[name] = {
                "url": rtsp_endpoint, "model": inference_model,
                "policy": annotation_policy, "priority": int(priority),
                "member": member, "placed_at": self._clock(),
                "migrations": 0,
            }
            self._m_placements.labels(member).inc()
            self._m_streams.set(len(self._streams))
        if self.journal is not None:
            trigger = {"member": member,
                       "policy": ("headroom" if row is not None
                                  and row.get("headroom") is not None
                                  else "score_ema" if row is not None
                                  else "hash_ring")}
            if row is not None:
                for key in ("headroom", "time_to_saturation_s",
                            "time_to_oom_s", "score_ema"):
                    if row.get(key) is not None:
                        trigger[key] = round(float(row[key]), 4)
            self.journal.record("router", "admit",
                                subject=("stream", name), trigger=trigger)
        return member

    def remove_stream(self, name: str) -> None:
        with self._lock:
            rec = self._streams.pop(name, None)
            self._m_streams.set(len(self._streams))
        if rec is not None:
            try:
                self.clients[rec["member"]].stop_stream(name)
            except Exception:  # noqa: BLE001 — member may already be gone
                log.warning("stop of %s on %s failed", name, rec["member"])

    def streams_on(self, member: str) -> List[str]:
        """This member's streams, lowest priority first (shed order)."""
        with self._lock:
            rows = [(rec["priority"], n) for n, rec in self._streams.items()
                    if rec["member"] == member]
        return [n for _, n in sorted(rows)]

    # -- migration protocol ------------------------------------------------

    def _resume_url(self, url: str, cursor: Optional[int]) -> str:
        """Rewrite a replay:// url's ``start`` to the handoff cursor;
        any other scheme (a live camera has no cursor) passes through."""
        if cursor is None or not url.startswith("replay://"):
            return url
        parts = urlsplit(url)
        q = {k: v[-1] for k, v in parse_qs(parts.query).items()}
        q["start"] = str(int(cursor))
        return urlunsplit(parts._replace(query=urlencode(q)))

    def _drain(self, client: MemberClient, stream: str,
               deadline: float) -> bool:
        """Poll the source's per-stream emitted-frame counter until it
        is static across two polls (engine drained everything the worker
        published) or the stream vanishes from stats."""
        last: Optional[int] = None
        while self._clock() < deadline:
            try:
                frames = client.stream_frames(stream)
            except Exception:  # noqa: BLE001 — source died mid-drain
                return False
            if frames is None or frames == last:
                return True
            last = frames
            self._sleep(self.drain_poll_s)
        return False

    def migrate(self, stream: str, *, reason: str = "admin",
                dst: Optional[str] = None, graceful: bool = True,
                detected_at: Optional[float] = None,
                cause: Optional[int] = None) -> Optional[str]:
        """drain→cutover→resume one stream. ``graceful=False`` is the
        dead-member path (source unreachable: no stop, no drain — the
        cursor resume re-produces the frames that died in flight).
        Returns the destination member, or None on failure (stream stays
        registered; the next pass retries)."""
        t_detect = detected_at if detected_at is not None else self._clock()
        with self._lock:
            rec = self._streams.get(stream)
            if rec is None:
                raise KeyError(stream)
            src = rec["member"]
            if dst is None:
                dst = self.ring.place(stream, exclude=(src,))
            if dst is not None and dst in self._draining:
                # Ring refresh lag: never migrate ONTO a draining member.
                dst = None
        if cause is None:
            # Link back to the router's own observation event for the
            # source member: the dead-member detection or the shedding
            # observation that provoked this move.
            cause = (self._evac_seq.get(src) if reason == "member_dead"
                     else self._shed_seq.get(src))
        if dst is None or dst == src:
            self._m_mig_fail.labels(reason).inc()
            if self.journal is not None:
                self.journal.record(
                    "router", "migrate_failed",
                    subject=("stream", stream),
                    trigger={"src": src, "reason": reason,
                             "error": "no_target"}, cause=cause)
            log.warning(
                "no migration target for %s (src=%s)", stream, src,
                extra={"vep_actor": "router",
                       "vep_subject": f"stream:{stream}"})
            return None
        entry = {"stream": stream, "src": src, "dst": dst,
                 "reason": reason, "graceful": bool(graceful)}
        drained = False
        if graceful:
            try:
                self.clients[src].stop_stream(stream)
                drained = self._drain(
                    self.clients[src], stream,
                    self._clock() + self.drain_timeout_s)
            except Exception:  # noqa: BLE001 — fall through
                # Source died mid-drain: continue on the dead-member path
                # (cursor resume covers the in-flight tail).
                log.warning("drain of %s on %s failed; cursor resume",
                            stream, src)
            if drained:
                # Settle one poll interval so results the engine emitted
                # right before going static finish their subscriber push
                # — the cursor read next must see every delivery, or the
                # resume leg would re-produce an already-delivered frame.
                self._sleep(self.drain_poll_s)
        entry["drained"] = drained
        cursor = None
        try:
            cursor = self._cursor_source(stream)
        except Exception:  # noqa: BLE001 — cursor plane optional
            log.exception("cursor source failed for %s", stream)
        entry["cursor"] = cursor
        try:
            self.clients[dst].start_stream(
                stream, self._resume_url(rec["url"], cursor),
                rec["model"], rec["policy"])
        except Exception as e:  # noqa: BLE001 — destination refused
            self._m_mig_fail.labels(reason).inc()
            entry.update(ok=False, error=f"{type(e).__name__}: {e}")
            self.ledger.record_migration(entry)
            if self.journal is not None:
                self.journal.record(
                    "router", "migrate_failed",
                    subject=("stream", stream),
                    trigger={"src": src, "dst": dst, "reason": reason,
                             "error": type(e).__name__}, cause=cause)
            return None
        t_done = self._clock()
        with self._lock:
            rec["member"] = dst
            rec["placed_at"] = t_done
            rec["migrations"] += 1
        replace_s = max(0.0, t_done - t_detect)
        self.last_replace_s = replace_s
        self._m_replace.observe(replace_s)
        self._m_migrations.labels(reason).inc()
        self._m_placements.labels(dst).inc()
        entry.update(ok=True, replace_s=round(replace_s, 4))
        self.ledger.record_migration(entry)
        seq = None
        if self.journal is not None:
            seq = self.journal.record(
                "router", "migrate", subject=("stream", stream),
                trigger={"src": src, "dst": dst, "reason": reason,
                         "replace_s": round(replace_s, 4),
                         "graceful": bool(graceful),
                         "cursor": -1 if cursor is None else int(cursor)},
                cause=cause)
        log.info("migrated %s: %s -> %s (%s, %.2fs, cursor=%s)",
                 stream, src, dst, reason, replace_s, cursor,
                 extra={"vep_actor": "router",
                        "vep_subject": f"stream:{stream}",
                        "vep_journal_seq": seq})
        return dst

    # -- the control loop --------------------------------------------------

    def run_pass(self) -> dict:
        """One scrape→decide→act pass (the background loop calls this
        every scrape interval; tests call it directly). Dead members
        fail over every stream this same pass — re-placement latency is
        bounded by one scrape interval by construction."""
        self.fleet.scrape_once()
        health = self.fleet.health()
        t_pass = self._clock()
        self._refresh_ring(health)
        moved: List[dict] = []
        by_name = {row["instance"]: row for row in health}
        # 1) dead members: evacuate everything, immediately.
        for member, row in sorted(by_name.items()):
            if row["up"] and not row["stale"]:
                self._evacuated.pop(member, None)
                self._evac_seq.pop(member, None)
                continue
            fresh = member not in self._evacuated
            detect = self._evacuated.setdefault(member, t_pass)
            if fresh and self.journal is not None:
                # Observation event: the detection itself, the cause
                # every member_dead migration below links back to.
                self._evac_seq[member] = self.journal.record(
                    "router", "member_dead", subject=("member", member),
                    trigger={"stale": bool(row["stale"]),
                             "streams": len(self.streams_on(member))})
            for stream in self.streams_on(member):
                dst = self.migrate(stream, reason="member_dead",
                                   graceful=False, detected_at=detect)
                moved.append({"stream": stream, "dst": dst,
                              "reason": "member_dead"})
        # 2) shedding members: burn fired, ladder reached shed_to_fleet,
        #    or the hysteresis band flipped unhealthy — move the
        #    lowest-priority streams to healthy peers, bounded per pass
        #    (a burning member drains gradually, not in one stampede).
        budget = self.max_moves_per_pass
        for member, row in sorted(by_name.items()):
            if budget <= 0:
                break
            if not row["up"] or row["stale"]:
                continue
            shedding = (
                bool(row.get("slo_burning"))
                or float(row.get("ladder_rung") or 0.0) >= _FLEET_RUNG_IDX
                or row.get("healthy") is False
            )
            if not shedding:
                self._shed_seq.pop(member, None)
                continue
            reason = ("slo_burn" if row.get("slo_burning")
                      else "shed_to_fleet"
                      if float(row.get("ladder_rung") or 0.0)
                      >= _FLEET_RUNG_IDX else "unhealthy")
            if member not in self._shed_seq and self.journal is not None:
                # Edge-triggered observation: the shedding verdict the
                # per-stream migrations below link back to.
                self._shed_seq[member] = self.journal.record(
                    "router", "member_shedding",
                    subject=("member", member),
                    trigger={"reason": reason,
                             "slo_burning": bool(row.get("slo_burning")),
                             "ladder_rung": float(
                                 row.get("ladder_rung") or 0.0)})
            for stream in self.streams_on(member)[:budget]:
                dst = self.migrate(stream, reason=reason,
                                   detected_at=t_pass)
                moved.append({"stream": stream, "dst": dst,
                              "reason": reason})
                budget -= 1
        self.passes += 1
        return {"health": health, "moved": moved,
                "ring": self.ring.members}

    # -- admin -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            streams = {n: dict(rec) for n, rec in self._streams.items()}
        return {
            "name": self.name,
            "members": sorted(self.clients),
            "ring": self.ring.members,
            "passes": self.passes,
            "scrape_interval_s": self.scrape_interval_s,
            "streams": streams,
            "breakers": {n: c.breaker.snapshot()
                         for n, c in sorted(self.clients.items())},
            "migrations": list(self.ledger.migrations),
            "last_replace_s": self.last_replace_s,
            "health": self.fleet.health(),
        }


def main(argv=None) -> None:
    """Standalone router process: place streams across members, watch
    health, migrate on burn/death; admin plane on stdlib http.server.

    Usage::

      python -m video_edge_ai_proxy_tpu_torch.serve.router \\
          --members m0=http://h0:8080 m1=http://h1:8080 --port 9091 \\
          --stream cam0=rtsp://... --stream cam1=replay:///t.vtrace?...
    """
    import argparse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--members", nargs="+", required=True,
                    help="member specs: name=http://host:port")
    ap.add_argument("--stream", action="append", default=[],
                    help="stream spec: name=<rtsp/replay url> "
                         "(repeatable)")
    ap.add_argument("--port", type=int, default=9091)
    ap.add_argument("--scrape-interval", type=float, default=1.0)
    ap.add_argument("--vnodes", type=int, default=64)
    args = ap.parse_args(argv)

    router = StreamRouter(
        args.members, scrape_interval_s=args.scrape_interval,
        base_vnodes=args.vnodes)
    router.run_pass()           # first placement view before streams land
    attach = router.attach()
    for spec in args.stream:
        name, sep, url = spec.partition("=")
        if not sep:
            raise SystemExit(f"--stream {spec!r}: expected name=url")
        member = router.add_stream(name, url)
        print(json.dumps({"placed": name, "member": member}), flush=True)
    router.start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?")[0]
            if path == "/metrics":
                body = obs_registry.render().encode()
                ctype = "text/plain; version=0.0.4"
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
    print(json.dumps({"router": router.name, "port": srv.server_port,
                      "members": sorted(router.clients),
                      "attach_errors": {k: v for k, v in attach.items()
                                        if v}}), flush=True)
    try:
        srv.serve_forever()
    finally:
        router.stop()
        router.detach()


if __name__ == "__main__":
    main()

"""Fleet telemetry plane (counterpart of
``video_edge_ai_proxy_tpu/obs/fleet.py``): multi-engine aggregation and
member health (MultiStream, arxiv 2207.06078: a many-camera monitor is
only operable when per-member telemetry rolls up into one pane). Every other obs module is process-local; this one makes N
engine processes read as one system:

- ``FleetAggregator`` scrapes each member's ``/metrics`` +
  ``/api/v1/stats`` + ``/api/v1/slo`` + ``/api/v1/capacity`` +
  ``/api/v1/journal`` over plain HTTP (stdlib urllib, dependency-free, importable from control-plane code). A member
  without a given plane (400/older version) degrades to an empty
  dict — mixed-version fleets merge.
- **Merge rules**: counters are SUMMED across members,
  log2 histograms are bucket-merged (identical ``le`` grids by
  construction — metrics.py owns the bounds), gauges are last-write per
  member with a staleness flag instead of a meaningless cross-member sum.
- ``merged_exposition()`` renders ONE lint-clean Prometheus text page:
  every member sample labeled ``instance="<member>"`` (preserved when the
  member already self-labels via ``Registry.set_const_labels``), plus the
  ``vep_fleet_*`` health families below.
- **Member health scoring**: liveness/staleness, SLO burn, degradation
  ladder rung and admitted-stream count folded into one ranked view —
  exactly the input the item-4 router will consume for shed/re-place
  decisions.

Serving: any member exposes ``/api/v1/fleet/stats`` +
``/api/v1/fleet/metrics`` when ``obs.fleet_members`` is configured
(serve/rest_api.py), and ``python -m video_edge_ai_proxy_tpu_torch.obs.fleet``
runs the same aggregator standalone on stdlib http.server.

Fleet metric families (all gauges unless noted):

- ``vep_fleet_members`` — configured member count
- ``vep_fleet_member_up{instance}`` — 1 after a successful last scrape
- ``vep_fleet_member_staleness_seconds{instance}`` — age of last good
  scrape
- ``vep_fleet_member_stale{instance}`` — staleness flag (dead OR older
  than the staleness bound)
- ``vep_fleet_member_health_score{instance}`` — ranked health in [0, 1]
- ``vep_fleet_member_health_score_ema{instance}`` — EMA-smoothed score
  (r16: the flap-free signal the router's placement decisions read)
- ``vep_fleet_member_healthy{instance}`` — hysteresis-banded verdict:
  flips healthy at ``score_ema >= healthy_above`` and unhealthy at
  ``score_ema <= unhealthy_below``; holds in between, so one noisy
  scrape cannot bounce a member in and out of the placement ring
- ``vep_fleet_member_health_state_age_seconds{instance}`` — seconds
  since the last healthy/unhealthy flip (``healthy_since`` /
  ``unhealthy_since``: the router requires a minimum healthy age before
  a member takes migrated streams)
- ``vep_fleet_member_slo_burning{instance}``
- ``vep_fleet_member_ladder_rung{instance}``
- ``vep_fleet_member_streams{instance}``
- ``vep_fleet_member_warming{instance}`` — 1 while a spawned member is
  scraped-alive but its prewarm program set is incomplete (r19: held
  out of the placement ring, never retired by the supervisor)
- ``vep_fleet_member_headroom{instance}`` — forecast capacity headroom
  in [0, 1] from the member's r18 capacity plane (-1 when the member
  does not report capacity — mixed-version fleet)
- ``vep_fleet_member_capacity_utilization{instance}`` — fast-window
  device-time utilization (-1 when unreported)
- ``vep_fleet_member_time_to_saturation_seconds{instance}`` —
  EWMA-slope saturation forecast (-1 when unreported or not burning
  toward saturation)
- ``vep_fleet_member_hbm_headroom_bytes{instance}`` — device-memory
  headroom from the member's r21 HBM plane (-1 when the member does not
  report it — mixed-version fleet)
- ``vep_fleet_member_hbm_utilization{instance}`` — fast-window HBM
  utilization (-1 when unreported)
- ``vep_fleet_member_time_to_oom_seconds{instance}`` — EWMA byte-slope
  OOM forecast (-1 when unreported or not trending toward OOM)
- ``vep_fleet_scrapes_total{instance}`` /
  ``vep_fleet_scrape_failures_total{instance}`` (counters)
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

_LABEL_TOKEN = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*(?:,|$)')


def parse_exposition(text: str) -> List[dict]:
    """Parse Prometheus text 0.0.4 into ordered families:
    ``[{name, kind, help, samples: [(sample_name, labels_str, value)]}]``.
    ``labels_str`` is the raw inside-braces text ("" when unlabeled);
    values stay floats. Tolerant of unannounced samples (untyped
    family synthesized) so a foreign member's page still merges."""
    fams: List[dict] = []
    by_name: Dict[str, dict] = {}

    def family(name: str) -> dict:
        fam = by_name.get(name)
        if fam is None:
            fam = {"name": name, "kind": "untyped", "help": "",
                   "samples": []}
            by_name[name] = fam
            fams.append(fam)
        return fam

    def base_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in by_name:
                return name[: -len(suffix)]
        return name

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                continue
            fam = family(parts[2])
            if line.startswith("# HELP "):
                fam["help"] = parts[3] if len(parts) > 3 else ""
            elif len(parts) > 3:
                fam["kind"] = parts[3]
            continue
        if line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < 0:
                continue
            name = line[:brace]
            labels = line[brace + 1:close]
            rest = line[close + 1:].strip()
        else:
            name, _, rest = line.partition(" ")
            labels = ""
        try:
            value = float(rest.split()[0])
        except (ValueError, IndexError):
            continue
        family(base_of(name))["samples"].append((name, labels, value))
    return fams


def _labels_dict(labels_str: str) -> Dict[str, str]:
    return {m.group(1): m.group(2)
            for m in _LABEL_TOKEN.finditer(labels_str)}


def _strip_label(labels_str: str, name: str) -> str:
    """Remove one ``name="..."`` pair from a raw label string."""
    pairs = [(m.group(1), m.group(2))
             for m in _LABEL_TOKEN.finditer(labels_str)]
    return ",".join(f'{n}="{v}"' for n, v in pairs if n != name)


def _with_instance(labels_str: str, instance: str) -> str:
    """Ensure the sample carries ``instance="..."`` (members that
    self-label via set_const_labels keep their own value)."""
    if re.search(r'(^|,)\s*instance="', labels_str):
        return labels_str
    pair = f'instance="{instance}"'
    return f"{pair},{labels_str}" if labels_str else pair


class MemberState:
    """Last-scrape snapshot of one fleet member (mutated only by the
    aggregator thread; read under the aggregator lock)."""

    def __init__(self, name: str, base_url: str):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.alive = False
        self.last_ok: Optional[float] = None     # time.monotonic()
        self.last_err = ""
        self.scrapes = 0
        self.failures = 0
        self.families: List[dict] = []
        self.stats: dict = {}
        self.slo: dict = {}
        self.capacity: dict = {}
        self.hbm: dict = {}
        self.journal: list = []
        # r16 flap-free health (updated once per scrape pass, never at
        # read time): EMA of the instantaneous score + a hysteresis-banded
        # healthy verdict with entry timestamps.
        self.score_ema: Optional[float] = None
        self.healthy: Optional[bool] = None
        self.healthy_since: Optional[float] = None    # time.monotonic()
        self.unhealthy_since: Optional[float] = None

    # -- derived health signals --

    def staleness_s(self, now: float) -> Optional[float]:
        return None if self.last_ok is None else max(0.0, now - self.last_ok)

    def streams(self) -> int:
        eng = (self.stats or {}).get("engine") or {}
        return len(eng.get("streams") or {})

    def warming(self) -> bool:
        """r19 spawn state: scraped-alive but the engine's prewarm
        program set is incomplete (a spawning member binds REST before
        it compiles — see serve/server.py boot order). Distinct from
        dead/stale: the member answers scrapes and scores normally, but
        the router holds it out of the placement ring and the
        supervisor never retires it. Members that do not report prewarm
        (engine-less, pre-r19) are never warming."""
        pw = ((self.stats or {}).get("engine") or {}).get("prewarm")
        if not isinstance(pw, dict):
            return False
        return self.alive and not bool(pw.get("complete", True))

    def burning(self) -> bool:
        return bool((self.slo or {}).get("burning"))

    def ladder_rung(self) -> float:
        for fam in self.families:
            if fam["name"] == "vep_ladder_rung":
                for _, _, value in fam["samples"]:
                    return float(value)
        return 0.0

    # r18 capacity signals; all None when the member does not report the
    # capacity plane (disabled or pre-r18 — mixed-version fleet).

    def headroom(self) -> Optional[float]:
        v = (self.capacity or {}).get("headroom")
        return float(v) if v is not None else None

    def capacity_util(self) -> Optional[float]:
        util = (self.capacity or {}).get("utilization") or {}
        v = util.get("fast")
        return float(v) if v is not None else None

    def time_to_saturation_s(self) -> Optional[float]:
        v = (self.capacity or {}).get("time_to_saturation_s")
        return float(v) if v is not None else None

    # r21 HBM signals; all None when the member does not report the HBM
    # plane (disabled or pre-r21 — mixed-version fleet).

    def hbm_headroom_bytes(self) -> Optional[float]:
        v = (self.hbm or {}).get("headroom_bytes")
        return float(v) if v is not None else None

    def hbm_util(self) -> Optional[float]:
        util = (self.hbm or {}).get("utilization") or {}
        v = util.get("fast")
        return float(v) if v is not None else None

    def time_to_oom_s(self) -> Optional[float]:
        v = (self.hbm or {}).get("time_to_oom_s")
        return float(v) if v is not None else None

    # r22 device-fault signals (rides /api/v1/stats -> obs.faults; no
    # extra fetch). None when the member does not report the fault
    # domain (disabled or pre-r22 — mixed-version fleet).

    def _faults(self) -> Optional[dict]:
        f = ((self.stats or {}).get("obs") or {}).get("faults")
        return f if isinstance(f, dict) else None

    def device_fault_failovers(self) -> Optional[int]:
        """Cumulative survivor-mesh failovers the member has executed —
        the supervisor's device_fault spawn trigger (an INCREASE means a
        chip just died; the member serves degraded on fewer shards)."""
        f = self._faults()
        if f is None or f.get("failovers") is None:
            return None
        return int(f["failovers"])

    def device_fault_active(self) -> Optional[bool]:
        """A fault window is open or shards are pending failover."""
        f = self._faults()
        return bool(f.get("active")) if f is not None else None


class FleetAggregator:
    """Scrape-and-merge tier over N member engines.

    ``members``: list of ``"name=http://host:port"`` (or bare URLs, which
    take ``m<i>`` names). ``scrape_interval_s`` paces the background
    thread (``start``/``stop``); ``scrape_once`` works without it.
    ``stale_after_s`` defaults to one scrape interval so a killed member
    is staleness-flagged by the very next pass."""

    def __init__(self, members, *, scrape_interval_s: float = 2.0,
                 stale_after_s: Optional[float] = None,
                 timeout_s: float = 2.0, ema_alpha: float = 0.4,
                 healthy_above: float = 0.7, unhealthy_below: float = 0.4):
        self._members: List[MemberState] = []
        for i, spec in enumerate(members):
            name, sep, url = str(spec).partition("=")
            if not sep:
                name, url = f"m{i}", str(spec)
            self._members.append(MemberState(name, url))
        # Auto-name sequence for bare-URL add_member specs. Monotonic —
        # a removal never frees its name for reuse, so add(m0,m1),
        # remove(m0), add(bare) yields m2, not a duplicate-m1 ValueError.
        self._auto_seq = len(self._members)
        self.scrape_interval_s = float(scrape_interval_s)
        self.stale_after_s = (float(stale_after_s) if stale_after_s
                              else self.scrape_interval_s)
        self.timeout_s = float(timeout_s)
        # r16 flap suppression: the EMA smooths the instantaneous score
        # and the two thresholds form a hysteresis band — a member flips
        # healthy only at >= healthy_above and unhealthy only at
        # <= unhealthy_below, holding its previous verdict in between.
        self.ema_alpha = float(ema_alpha)
        self.healthy_above = float(healthy_above)
        self.unhealthy_below = float(unhealthy_below)
        if not (0.0 <= self.unhealthy_below <= self.healthy_above <= 1.0):
            raise ValueError(
                f"hysteresis band must satisfy 0 <= unhealthy_below <= "
                f"healthy_above <= 1, got [{unhealthy_below}, "
                f"{healthy_above}]")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_scrape_wall_ms = 0.0

    # -- lifecycle --

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-scrape", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + 1.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.scrape_interval_s)

    # -- membership (r19 supervisor hooks) --

    def add_member(self, spec: str) -> str:
        """Register one member at runtime (``"name=url"`` or a bare URL,
        auto-named from a monotonic ``m<N>`` sequence — never reusing a
        removed member's name); the next scrape pass picks it up.
        Returns the member name; duplicates raise."""
        name, sep, url = str(spec).partition("=")
        with self._lock:
            if not sep:
                url = str(spec)
                # Skip operator-claimed m<N> names too, not just our own.
                while any(m.name == f"m{self._auto_seq}"
                          for m in self._members):
                    self._auto_seq += 1
                name = f"m{self._auto_seq}"
                self._auto_seq += 1
            if any(m.name == name for m in self._members):
                raise ValueError(f"member {name!r} already registered")
            self._members.append(MemberState(name, url))
        return name

    def remove_member(self, name: str) -> None:
        """Deregister a member; its health rows and merged samples stop
        at the next read. Unknown names are a no-op (retire after a
        crash-remove race must not raise). The list is replaced, not
        mutated, so a concurrently running scrape pass finishes over the
        snapshot it started with."""
        with self._lock:
            self._members = [m for m in self._members if m.name != name]

    # -- scraping --

    def _fetch(self, url: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read()

    def scrape_once(self) -> dict:
        """One pass over every member; returns the health view. Errors
        mark the member down (failures counted) — never raise."""
        t0 = time.monotonic()
        for m in self._members:
            try:
                text = self._fetch(m.base_url + "/metrics").decode()
                stats = json.loads(self._fetch(m.base_url + "/api/v1/stats"))
                try:
                    slo = json.loads(self._fetch(m.base_url + "/api/v1/slo"))
                except Exception:
                    slo = {}   # SLO plane disabled on the member (400)
                try:
                    capacity = json.loads(
                        self._fetch(m.base_url + "/api/v1/capacity"))
                except Exception:
                    # Capacity plane disabled (400) or a pre-r18 member
                    # (404) — merge the rest; health rows carry None.
                    capacity = {}
                try:
                    hbm = json.loads(
                        self._fetch(m.base_url + "/api/v1/hbm"))
                except Exception:
                    # HBM plane disabled (400) or a pre-r21 member (404)
                    # — merge the rest; health rows carry None and the
                    # fleet gauges render -1 sentinels.
                    hbm = {}
                try:
                    journal = json.loads(
                        self._fetch(m.base_url + "/api/v1/journal")
                    ).get("events") or []
                except Exception:
                    # Journal disabled (400) or a pre-r23 member (404)
                    # — the merged journal just misses this member.
                    journal = []
                with self._lock:
                    m.families = parse_exposition(text)
                    m.stats = stats
                    m.slo = slo
                    m.capacity = capacity
                    m.hbm = hbm
                    m.journal = journal
                    m.alive = True
                    m.last_ok = time.monotonic()
                    m.last_err = ""
                    m.scrapes += 1
            except Exception as e:  # noqa: BLE001 — any member fault
                with self._lock:
                    m.alive = False
                    m.last_err = f"{type(e).__name__}: {e}"
                    m.failures += 1
        # One EMA/hysteresis update per PASS (not per read): health()
        # stays a pure view, so concurrent readers cannot double-fold a
        # sample into the EMA or race the band state.
        now = time.monotonic()
        with self._lock:
            for m in self._members:
                score = self._raw_score(m, now)
                m.score_ema = score if m.score_ema is None else (
                    self.ema_alpha * score
                    + (1.0 - self.ema_alpha) * m.score_ema)
                if m.score_ema >= self.healthy_above:
                    verdict = True
                elif m.score_ema <= self.unhealthy_below:
                    verdict = False
                else:
                    # Mid-band: hold the previous verdict; a brand-new
                    # member starting mid-band is optimistically healthy
                    # (the placement ring would otherwise be empty at
                    # boot).
                    verdict = m.healthy if m.healthy is not None else True
                if verdict != m.healthy:
                    m.healthy = verdict
                    if verdict:
                        m.healthy_since = now
                        m.unhealthy_since = None
                    else:
                        m.unhealthy_since = now
                        m.healthy_since = None
        self._last_scrape_wall_ms = (time.monotonic() - t0) * 1000.0
        return self.health()

    # -- health --

    def _raw_score(self, m: MemberState, now: float) -> float:
        """Instantaneous health score in [0, 1] (the r14 formula); the
        EMA/hysteresis layer on top is what the router consumes."""
        staleness = m.staleness_s(now)
        stale = (not m.alive) or staleness is None \
            or staleness > self.stale_after_s
        if (not m.alive and m.last_ok is None) or stale:
            return 0.0
        return max(0.0, min(1.0, (
            1.0 - (0.5 if m.burning() else 0.0)
            - 0.15 * m.ladder_rung() - 0.02 * m.streams())))

    def _member_health(self, m: MemberState, now: float) -> dict:
        staleness = m.staleness_s(now)
        stale = (not m.alive) or staleness is None \
            or staleness > self.stale_after_s
        rung = m.ladder_rung()
        streams = m.streams()
        burning = m.burning()
        score = self._raw_score(m, now)
        return {
            "instance": m.name,
            "url": m.base_url,
            "up": m.alive,
            "stale": stale,
            "staleness_s": round(staleness, 3)
            if staleness is not None else None,
            "slo_burning": burning,
            "ladder_rung": rung,
            "streams": streams,
            "warming": m.warming(),
            # r18 capacity plane (None-keyed when the member does not
            # report it — the router treats those as capacity-less).
            "capacity": bool(m.capacity),
            "headroom": m.headroom(),
            "capacity_utilization": m.capacity_util(),
            "time_to_saturation_s": m.time_to_saturation_s(),
            # r21 HBM plane (None-keyed when unreported — the router
            # treats those as memory-blind, admitting on time alone).
            "hbm": bool(m.hbm),
            "hbm_headroom_bytes": m.hbm_headroom_bytes(),
            "hbm_utilization": m.hbm_util(),
            "time_to_oom_s": m.time_to_oom_s(),
            # r22 device-fault domain (None-keyed when unreported — the
            # supervisor skips fault-blind members).
            "device_fault_failovers": m.device_fault_failovers(),
            "device_fault_active": m.device_fault_active(),
            "score": round(score, 4),
            "score_ema": round(m.score_ema, 4)
            if m.score_ema is not None else None,
            "healthy": m.healthy,
            "healthy_since_s": round(now - m.healthy_since, 3)
            if m.healthy_since is not None else None,
            "unhealthy_since_s": round(now - m.unhealthy_since, 3)
            if m.unhealthy_since is not None else None,
            "scrapes": m.scrapes,
            "failures": m.failures,
            "last_err": m.last_err,
        }

    def health(self) -> List[dict]:
        """Per-member health, ranked best-first (the router's shed /
        re-place input: shed FROM the tail, place ONTO the head)."""
        now = time.monotonic()
        with self._lock:
            rows = [self._member_health(m, now) for m in self._members]
        rows.sort(key=lambda r: (-r["score"], r["instance"]))
        return rows

    # -- merging --

    def _merge(self) -> Tuple[dict, dict, dict]:
        """(counters, gauges, histograms) merged across live members.

        counters:   {family: {labels: {"value": sum,
                     "instances": {name: v}}}}   — sum semantics
        gauges:     {family: {labels: {"value": last-write,
                     "instance": name, "stale": bool,
                     "instances": {name: {"value": v, "stale": bool}}}}}
        histograms: {family: {labels: {"buckets": {le: cum}, "sum": s,
                     "count": n}}}               — bucket-wise sum
        ``labels`` excludes instance/le. Last-write for a gauge = the
        most recently scraped member carrying it (scrape order breaks
        ties); its staleness rides along as the flag."""
        counters: dict = {}
        gauges: dict = {}
        hists: dict = {}
        now = time.monotonic()
        with self._lock:
            members = [(m, m.staleness_s(now), m.families)
                       for m in self._members]
            stale_bound = self.stale_after_s
        order = sorted(
            (m for m in members if m[1] is not None),
            key=lambda t: t[1], reverse=True)  # stalest first, freshest last
        for m, staleness, fams in order:
            stale = (not m.alive) or staleness > stale_bound
            for fam in fams:
                kind = fam["kind"]
                if kind == "counter":
                    slot = counters.setdefault(fam["name"], {})
                    for _, labels, value in fam["samples"]:
                        key = _strip_label(labels, "instance")
                        row = slot.setdefault(
                            key, {"value": 0.0, "instances": {}})
                        row["value"] += value
                        row["instances"][m.name] = value
                elif kind == "gauge":
                    slot = gauges.setdefault(fam["name"], {})
                    for _, labels, value in fam["samples"]:
                        key = _strip_label(labels, "instance")
                        row = slot.setdefault(key, {"instances": {}})
                        row["instances"][m.name] = {
                            "value": value, "stale": stale}
                        row["value"] = value        # last write wins
                        row["instance"] = m.name
                        row["stale"] = stale
                elif kind == "histogram":
                    slot = hists.setdefault(fam["name"], {})
                    for name, labels, value in fam["samples"]:
                        key = _strip_label(
                            _strip_label(labels, "instance"), "le")
                        row = slot.setdefault(
                            key, {"buckets": {}, "sum": 0.0, "count": 0})
                        if name.endswith("_bucket"):
                            le = _labels_dict(labels).get("le", "+Inf")
                            row["buckets"][le] = \
                                row["buckets"].get(le, 0.0) + value
                        elif name.endswith("_sum"):
                            row["sum"] += value
                        elif name.endswith("_count"):
                            row["count"] += int(value)
        return counters, gauges, hists

    def merged_journal(self) -> dict:
        """The ``/api/v1/fleet/journal`` body (r23): every member's
        decision-journal events tagged ``member=<name>``, merged in
        ``(ts, member, seq)`` order — the per-member seqs are monotone,
        so the merge is deterministic across scrape arrival orders (the
        r14 stitching idiom, journal edition)."""
        from .journal import merge_journals

        with self._lock:
            per_member = {m.name: list(m.journal) for m in self._members}
        events = merge_journals(per_member)
        return {
            "members": sorted(per_member),
            "events": events,
        }

    def fleet_stats(self) -> dict:
        """The ``/api/v1/fleet/stats`` body: ranked health + merged
        counters/gauges/histograms + scrape-plane accounting."""
        counters, gauges, hists = self._merge()
        return {
            "members": len(self._members),
            "scrape_interval_s": self.scrape_interval_s,
            "stale_after_s": self.stale_after_s,
            "last_scrape_wall_ms": round(self._last_scrape_wall_ms, 3),
            "health": self.health(),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "journal": {m.name: len(m.journal) for m in self._members},
        }

    def _fleet_families(self) -> List[str]:
        health = self.health()
        lines = [
            "# HELP vep_fleet_members Configured fleet member count",
            "# TYPE vep_fleet_members gauge",
            f"vep_fleet_members {len(self._members)}",
        ]

        def fam(name, kind, help_text, key, cast=lambda v: f"{v:g}"):
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for row in health:
                val = key(row)
                lines.append(
                    f'{name}{{instance="{row["instance"]}"}} {cast(val)}')

        fam("vep_fleet_member_up", "gauge",
            "1 when the member's last scrape succeeded",
            lambda r: 1.0 if r["up"] else 0.0)
        fam("vep_fleet_member_stale", "gauge",
            "1 when the member is dead or past the staleness bound",
            lambda r: 1.0 if r["stale"] else 0.0)
        fam("vep_fleet_member_staleness_seconds", "gauge",
            "Age of the member's last successful scrape",
            lambda r: r["staleness_s"]
            if r["staleness_s"] is not None else -1.0)
        fam("vep_fleet_member_health_score", "gauge",
            "Ranked member health in [0,1] (router placement input)",
            lambda r: r["score"])
        fam("vep_fleet_member_health_score_ema", "gauge",
            "EMA-smoothed member health score (flap-free router signal)",
            lambda r: r["score_ema"] if r["score_ema"] is not None
            else -1.0)
        fam("vep_fleet_member_healthy", "gauge",
            "Hysteresis-banded member health verdict (1=healthy)",
            lambda r: -1.0 if r["healthy"] is None
            else (1.0 if r["healthy"] else 0.0))
        fam("vep_fleet_member_health_state_age_seconds", "gauge",
            "Seconds since the member's last healthy/unhealthy flip",
            lambda r: r["healthy_since_s"]
            if r["healthy_since_s"] is not None
            else (r["unhealthy_since_s"]
                  if r["unhealthy_since_s"] is not None else -1.0))
        fam("vep_fleet_member_slo_burning", "gauge",
            "1 when the member's SLO engine reports burning",
            lambda r: 1.0 if r["slo_burning"] else 0.0)
        fam("vep_fleet_member_ladder_rung", "gauge",
            "Member degradation-ladder rung index",
            lambda r: r["ladder_rung"])
        fam("vep_fleet_member_streams", "gauge",
            "Member admitted-stream count",
            lambda r: r["streams"])
        fam("vep_fleet_member_warming", "gauge",
            "1 while a spawned member is scraped-alive but its prewarm "
            "program set is incomplete (held out of placement, never "
            "retired)",
            lambda r: 1.0 if r.get("warming") else 0.0)
        fam("vep_fleet_member_headroom", "gauge",
            "Forecast capacity headroom in [0,1] (-1 when unreported)",
            lambda r: r["headroom"] if r["headroom"] is not None else -1.0)
        fam("vep_fleet_member_capacity_utilization", "gauge",
            "Fast-window device-time utilization (-1 when unreported)",
            lambda r: r["capacity_utilization"]
            if r["capacity_utilization"] is not None else -1.0)
        fam("vep_fleet_member_time_to_saturation_seconds", "gauge",
            "EWMA-slope saturation forecast (-1 when unreported or not "
            "trending toward saturation)",
            lambda r: r["time_to_saturation_s"]
            if r["time_to_saturation_s"] is not None else -1.0)
        fam("vep_fleet_member_hbm_headroom_bytes", "gauge",
            "Device-memory headroom in bytes (-1 when unreported)",
            lambda r: r["hbm_headroom_bytes"]
            if r["hbm_headroom_bytes"] is not None else -1.0)
        fam("vep_fleet_member_hbm_utilization", "gauge",
            "Fast-window HBM utilization (-1 when unreported)",
            lambda r: r["hbm_utilization"]
            if r["hbm_utilization"] is not None else -1.0)
        fam("vep_fleet_member_time_to_oom_seconds", "gauge",
            "EWMA byte-slope OOM forecast (-1 when unreported or not "
            "trending toward OOM)",
            lambda r: r["time_to_oom_s"]
            if r["time_to_oom_s"] is not None else -1.0)
        fam("vep_fleet_scrapes_total", "counter",
            "Successful member scrapes", lambda r: r["scrapes"])
        fam("vep_fleet_scrape_failures_total", "counter",
            "Failed member scrapes", lambda r: r["failures"])
        return lines

    def merged_exposition(self) -> str:
        """One Prometheus text page for the whole fleet: every member
        sample with an ``instance`` label (contiguous per family — the
        member pages are re-grouped, not concatenated) plus the
        ``vep_fleet_*`` families. Lint-clean under
        ``metrics.lint_exposition`` (tested on member AND merged
        output)."""
        with self._lock:
            per_member = [(m.name, m.families) for m in self._members
                          if m.families]
        merged: Dict[str, dict] = {}
        order: List[str] = []
        for name, fams in per_member:
            for fam in fams:
                slot = merged.get(fam["name"])
                if slot is None:
                    slot = {"kind": fam["kind"], "help": fam["help"],
                            "samples": []}
                    merged[fam["name"]] = slot
                    order.append(fam["name"])
                for sample_name, labels, value in fam["samples"]:
                    slot["samples"].append(
                        (sample_name, _with_instance(labels, name), value))
        lines: List[str] = []
        seen: set = set()
        for fname in order:
            fam = merged[fname]
            if fam["help"]:
                lines.append(f"# HELP {fname} {fam['help']}")
            lines.append(f"# TYPE {fname} {fam['kind']}")
            for sample_name, labels, value in fam["samples"]:
                key = (sample_name, labels)
                if key in seen:   # two members claiming one identity
                    continue
                seen.add(key)
                ls = "{" + labels + "}" if labels else ""
                lines.append(f"{sample_name}{ls} {value:g}")
        lines.extend(self._fleet_families())
        return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    """Standalone aggregator: scrape members, serve the merged plane on
    stdlib http.server (no aiohttp, no torch: deployable next to any member).

    Usage::

      python -m video_edge_ai_proxy_tpu_torch.obs.fleet \\
          --members m0=http://h0:8080 m1=http://h1:8080 --port 9090
    """
    import argparse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--members", nargs="+", required=True,
                    help="member specs: name=http://host:port (or bare "
                         "URLs, auto-named m0..mN)")
    ap.add_argument("--port", type=int, default=9090)
    ap.add_argument("--scrape-interval", type=float, default=2.0)
    ap.add_argument("--stale-after", type=float, default=0.0,
                    help="staleness bound seconds (0 = one scrape "
                         "interval)")
    args = ap.parse_args(argv)

    agg = FleetAggregator(
        args.members, scrape_interval_s=args.scrape_interval,
        stale_after_s=args.stale_after or None)
    agg.start()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            if self.path.split("?")[0] in ("/metrics",
                                           "/api/v1/fleet/metrics"):
                body = agg.merged_exposition().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path.split("?")[0] == "/api/v1/fleet/stats":
                body = json.dumps(agg.fleet_stats()).encode()
                ctype = "application/json"
            elif self.path.split("?")[0] == "/api/v1/fleet/journal":
                body = json.dumps(agg.merged_journal()).encode()
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
    print(json.dumps({"fleet_aggregator": True, "port": srv.server_port,
                      "members": len(agg._members)}), flush=True)
    try:
        srv.serve_forever()
    finally:
        agg.stop()


if __name__ == "__main__":
    main()

"""Declarative SLOs with multi-window burn-rate evaluation (counterpart of
``video_edge_ai_proxy_tpu/obs/slo.py``).

The serving limits (p50 capture->result latency, aggregate frames/s,
stream availability) as live service objectives evaluated the way SRE
burn-rate alerting does it: an SLO fires only when BOTH the fast (5 min)
and the slow (1 h) window burn error budget faster than the threshold,
and resolves as soon as the fast window clears.

The engine feeds per-frame good/bad latency events from the drain and
per-tick frames/s and availability samples from the tick loop;
``SLOEngine.evaluate`` runs about once a second off the tick, and its
``burning`` verdict feeds the degradation ladder as extra pressure.

- Fixed time-binned rings: ``record`` is index math on flat lists, no
  allocation on the per-frame path.
- Warmup guard: no SLO fires before ``warmup_s`` of wall time since its
  first event.
- Injectable clock, so burn-rate math is tested on fake time.

With a decision journal each episode's opening and closing is an event
(``slo.episode_open``/``episode_close``, the burn numbers as trigger;
``last_open_seq`` is the cause the ladder links an SLO-driven escalation
to), and with a watchdog each SLO is an episode ``slo_burn:<name>``
logged once per excursion. ``integrity_slo`` is the canary loop's
objective.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from . import metrics


@dataclass(frozen=True)
class SLOSpec:
    """Declarative objective: ``objective`` is the target good fraction
    (0.99 = 1% error budget); ``fire_burn_rate`` is the budget-burn
    multiple both windows must exceed to open an episode (14.4 = the
    standard 2%-of-monthly-budget-per-hour page threshold)."""

    name: str
    objective: float
    description: str = ""
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fire_burn_rate: float = 14.4
    warmup_s: float = 60.0
    bin_s: float = 10.0


class _BinRing:
    """Good/bad event totals in fixed time bins covering the slow window.

    Each bin is addressed by its absolute epoch (``now // bin_s``); a
    slot is reset lazily when a new epoch claims it, so recording is
    O(1) with no allocation and window totals are an O(n_bins) scan
    (n_bins ~ 360), done only at evaluate time.
    """

    __slots__ = ("_bin_s", "_n", "_good", "_bad", "_epochs")

    def __init__(self, span_s: float, bin_s: float):
        self._bin_s = float(bin_s)
        self._n = max(int(math.ceil(span_s / bin_s)) + 1, 2)
        self._good = [0.0] * self._n
        self._bad = [0.0] * self._n
        self._epochs = [-1] * self._n

    def record(self, good: float, bad: float, now: float) -> None:
        epoch = int(now // self._bin_s)
        i = epoch % self._n
        if self._epochs[i] != epoch:
            self._epochs[i] = epoch
            self._good[i] = 0.0
            self._bad[i] = 0.0
        self._good[i] += good
        self._bad[i] += bad

    def totals(self, window_s: float, now: float):
        """(good, bad) summed over bins younger than ``window_s``."""
        lo_epoch = int((now - window_s) // self._bin_s)
        now_epoch = int(now // self._bin_s)
        good = bad = 0.0
        for i in range(self._n):
            e = self._epochs[i]
            if lo_epoch < e <= now_epoch:
                good += self._good[i]
                bad += self._bad[i]
        return good, bad


class BurnRateSLO:
    """One objective: records good/bad events, evaluates multi-window
    burn, keeps episode state, and feeds ``vep_slo_*`` gauges."""

    def __init__(self, spec: SLOSpec, *, clock=time.monotonic,
                 registry: Optional[metrics.Registry] = None,
                 journal=None):
        if not 0.0 < spec.objective < 1.0:
            raise ValueError(
                f"SLO {spec.name!r}: objective must be in (0, 1), "
                f"got {spec.objective}")
        reg = registry if registry is not None else metrics.registry
        self.spec = spec
        self.budget = 1.0 - spec.objective
        self._clock = clock
        self._lock = threading.Lock()
        self._ring = _BinRing(spec.slow_window_s, spec.bin_s)
        self._t0: Optional[float] = None   # first recorded event
        self.firing = False
        self.episodes = 0
        self._last: dict = {"fast": None, "slow": None}
        # Decision journal: episode open/close events; last_open_seq is
        # the cause handle the ladder links SLO-driven transitions to.
        self.journal = journal
        self.last_open_seq: Optional[int] = None
        self._g_fast = reg.gauge(
            "vep_slo_burn_rate",
            "Error-budget burn-rate multiple per window",
            ("slo", "window")).labels(spec.name, "fast")
        self._g_slow = reg.gauge(
            "vep_slo_burn_rate", "", ("slo", "window")).labels(
                spec.name, "slow")
        self._g_firing = reg.gauge(
            "vep_slo_firing", "1 while the SLO burn episode is open",
            ("slo",)).labels(spec.name)
        self._c_episodes = reg.counter(
            "vep_slo_episodes_total", "Opened SLO burn episodes",
            ("slo",)).labels(spec.name)

    @property
    def name(self) -> str:
        return self.spec.name

    def record(self, good: float = 0.0, bad: float = 0.0) -> None:
        """Count events against the objective (hot path: index math)."""
        now = self._clock()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._ring.record(good, bad, now)

    def burn_rate(self, window_s: float) -> Optional[float]:
        """Budget-burn multiple over the window: (bad fraction)/budget.
        None when the window holds no events."""
        now = self._clock()
        with self._lock:
            good, bad = self._ring.totals(window_s, now)
        total = good + bad
        if total <= 0.0:
            return None
        return (bad / total) / self.budget

    def evaluate(self, watchdog=None) -> dict:
        """Update episode state from both windows; returns the state dict
        served at /api/v1/slo."""
        spec = self.spec
        now = self._clock()
        fast = self.burn_rate(spec.fast_window_s)
        slow = self.burn_rate(spec.slow_window_s)
        with self._lock:
            covered = (self._t0 is not None
                       and now - self._t0 >= spec.warmup_s)
            burning = (covered and fast is not None and slow is not None
                       and fast > spec.fire_burn_rate
                       and slow > spec.fire_burn_rate)
            opened = closed = False
            if burning and not self.firing:
                self.firing = True
                self.episodes += 1
                self._c_episodes.inc()
                opened = True
            elif self.firing and (fast is None
                                  or fast <= spec.fire_burn_rate):
                # Fast window clearing resolves the episode: budget is no
                # longer burning *now*, even though the slow window still
                # remembers the excursion.
                self.firing = False
                closed = True
            self._last = {"fast": fast, "slow": slow}
        if self.journal is not None and opened:
            self.last_open_seq = self.journal.record(
                "slo", "episode_open", subject=("slo", spec.name),
                trigger={"fast": fast, "slow": slow,
                         "threshold": spec.fire_burn_rate})
        elif self.journal is not None and closed:
            self.journal.record(
                "slo", "episode_close", subject=("slo", spec.name),
                trigger={"fast": fast, "slow": slow,
                         "threshold": spec.fire_burn_rate,
                         "episodes": self.episodes},
                cause=self.last_open_seq)
        if fast is not None:
            self._g_fast.set(fast)
        if slow is not None:
            self._g_slow.set(slow)
        self._g_firing.set(1.0 if self.firing else 0.0)
        if watchdog is not None:
            # The once-per-episode operator log, keyed per SLO so that
            # concurrent burns log independently.
            watchdog.check(
                f"slo_burn:{spec.name}",
                fast if (covered and fast is not None) else 0.0,
                above=spec.fire_burn_rate,
                detail=(f"fast={fast} slow={slow} "
                        f"threshold={spec.fire_burn_rate}"))
        return self.state()

    def state(self) -> dict:
        with self._lock:
            return {
                "objective": self.spec.objective,
                "description": self.spec.description,
                "windows_s": {"fast": self.spec.fast_window_s,
                              "slow": self.spec.slow_window_s},
                "fire_burn_rate": self.spec.fire_burn_rate,
                "burn": dict(self._last),
                "firing": self.firing,
                "episodes": self.episodes,
            }


def default_slos(*, latency_ms: float = 40.0, target_fps: float = 1000.0,
                 warmup_s: float = 60.0) -> Iterable[SLOSpec]:
    """The three serving objectives, as specs.

    The latency objective is a p50 expressed as burn rate: objective 0.5
    means at most half the detect frames may exceed ``latency_ms``; a
    burn multiple > 1.2 therefore reads "the p50 is above target".
    """
    return (
        SLOSpec(
            name="detect_latency_p50",
            objective=0.5,
            description=(f"p50 detect publish->emit latency < "
                         f"{latency_ms:g} ms"),
            fire_burn_rate=1.2,
            warmup_s=warmup_s,
        ),
        SLOSpec(
            name="aggregate_fps",
            objective=0.99,
            description=(f"aggregate emitted fps >= {target_fps:g} "
                         f"(per-tick samples)"),
            fire_burn_rate=14.4,
            warmup_s=warmup_s,
        ),
        SLOSpec(
            name="stream_availability",
            objective=0.99,
            description="inferred streams emitting within the "
                        "availability window (per-stream per-tick "
                        "samples)",
            fire_burn_rate=14.4,
            warmup_s=warmup_s,
        ),
    )


def integrity_slo(*, warmup_s: float = 60.0) -> SLOSpec:
    """The canary-integrity objective (obs/quality.py CanaryChecker):
    virtually every golden-replay cycle must reproduce the committed
    result checksum. Cycles are rare events (one per trace loop, a
    handful per fast window), so a single mismatch burns far above 1.0
    and fires as soon as the window is covered — integrity failures are
    binary, not budgeted like latency."""
    return SLOSpec(
        name="canary_integrity",
        objective=0.99,
        description="canary golden-replay cycles matching the committed "
                    "result checksum",
        fire_burn_rate=1.0,
        warmup_s=warmup_s,
    )


class SLOEngine:
    """A set of burn-rate SLOs with one evaluate/snapshot surface.

    Owned by the inference engine; ``evaluate`` runs off the engine tick
    (throttled there to ~1/s), pushes gauges and the once-per-episode
    watchdog lines, and returns the aggregate ``burning`` verdict the
    degradation ladder consumes.
    """

    def __init__(self, specs: Iterable[SLOSpec] = (), *,
                 clock=time.monotonic,
                 registry: Optional[metrics.Registry] = None,
                 watchdog=None, journal=None):
        self._watchdog = watchdog
        self.journal = journal
        self._slos: Dict[str, BurnRateSLO] = {}
        for spec in specs:
            self.add(BurnRateSLO(spec, clock=clock, registry=registry,
                                 journal=journal))

    def add(self, slo: BurnRateSLO) -> BurnRateSLO:
        if slo.journal is None:
            slo.journal = self.journal
        self._slos[slo.name] = slo
        return slo

    def get(self, name: str) -> BurnRateSLO:
        return self._slos[name]

    def record(self, name: str, *, good: float = 0.0,
               bad: float = 0.0) -> None:
        self._slos[name].record(good=good, bad=bad)

    def evaluate(self) -> dict:
        """Evaluate every SLO; {"burning": any-firing, "slos": {...}}."""
        states = {name: slo.evaluate(self._watchdog)
                  for name, slo in sorted(self._slos.items())}
        return {"burning": any(s["firing"] for s in states.values()),
                "slos": states}

    def burning(self) -> bool:
        """Aggregate verdict from the LAST evaluate (no re-evaluation:
        cheap enough for per-tick ladder reads)."""
        return any(slo.firing for slo in self._slos.values())

    def snapshot(self) -> dict:
        """JSON-able state of every SLO."""
        return {"burning": self.burning(),
                "slos": {name: slo.state()
                         for name, slo in sorted(self._slos.items())}}

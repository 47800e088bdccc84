"""Capacity attribution plane (counterpart of
``video_edge_ai_proxy_tpu/obs/capacity.py``): the per-stream device-time
ledger, headroom forecasting and burn-rate accounting that feed admission.

- **The ledger.** Every measured batch's device time is amortized back to
  its occupant streams: full-frame streams split a bucket's cost equally
  by slot, ROI canvas streams by their packed canvas area
  (``CropPlacement.dst``), the cascade head's dispatches among their due
  tracks' streams (raw cost in the ledger, the cadence-amortized per-tick
  figure beside it). The float residual of the split folds into the last
  share, so the attributed and measured totals advance by the same float:
  ``conservation()`` reads a drift of 0.0. Rows idle past the slow window
  expire; the running totals are counters and stay balanced.
- **Headroom and forecast.** Busy device milliseconds go into time-binned
  rings per (model, geometry, bucket) cell and in aggregate; utilization
  is the busy share of the window's wall time; ``evaluate`` (throttled,
  driven by the engine's tick) smooths the utilization slope (EWMA) into
  ``time_to_saturation_s``. Burn rates follow the multi-window recipe:
  window utilization over the objective, burning when both windows
  exceed it.
- **Surfaces.** The ``vep_capacity_*`` families, ``snapshot()`` for
  ``/api/v1/capacity`` and the ``/api/v1/stats`` embed, and the fleet
  merge (``obs/fleet.py``).

The port's engine feeds ``note_batch`` with its ``device_ms``: the CUDA
event span of the step on the card (JAX's is submit -> drained). On the
CPU it is the host's submit -> drained span. Under a mesh of device slots
the engine passes ``shard_streams`` (each slot's occupant streams), with
the JAX signature: each listed slot's measured and attributed ledgers
advance by the batch's whole device time.

Metric families (gauges unless noted):

- ``vep_capacity_stream_device_ms_total{stream,kind}`` (counter)
- ``vep_capacity_attributed_ms_total`` / ``vep_capacity_measured_ms_total``
  (counters): the conservation invariant
- ``vep_capacity_shard_attributed_ms_total{shard}`` /
  ``vep_capacity_shard_measured_ms_total{shard}`` (counters)
- ``vep_capacity_utilization{window}``, ``vep_capacity_burn_rate{window}``
- ``vep_capacity_headroom``, ``vep_capacity_time_to_saturation_seconds``
  (-1 = not saturating)
- ``vep_capacity_cell_utilization{model,geometry,bucket}``

Standard library only: importable from control-plane code.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics

# Streams a batch could not be attributed to (empty occupant list —
# defensive; the engine always knows its occupants) land here so the
# conservation invariant still holds.
OVERHEAD_STREAM = "_overhead"

# Conservation tolerance: attributed and measured totals are the same
# float sums reordered, so drift is bounded by accumulation rounding.
CONSERVATION_REL_TOL = 1e-6


class _BusyRing:
    """Busy-milliseconds totals in fixed time bins covering the slow
    window (the obs/slo.py ``_BinRing`` idiom, single series): each bin
    is addressed by its absolute epoch and reset lazily when a new epoch
    claims it, so recording is O(1) index math with no allocation and a
    window total is an O(n_bins) scan done only at evaluate time."""

    __slots__ = ("_bin_s", "_n", "_busy", "_epochs")

    def __init__(self, span_s: float, bin_s: float):
        self._bin_s = float(bin_s)
        self._n = max(int(math.ceil(span_s / bin_s)) + 1, 2)
        self._busy = [0.0] * self._n
        self._epochs = [-1] * self._n

    def record(self, busy_ms: float, now: float) -> None:
        epoch = int(now // self._bin_s)
        i = epoch % self._n
        if self._epochs[i] != epoch:
            self._epochs[i] = epoch
            self._busy[i] = 0.0
        self._busy[i] += busy_ms

    def total(self, window_s: float, now: float) -> float:
        """Busy ms summed over bins younger than ``window_s``."""
        lo_epoch = int((now - window_s) // self._bin_s)
        now_epoch = int(now // self._bin_s)
        busy = 0.0
        for i in range(self._n):
            e = self._epochs[i]
            if lo_epoch < e <= now_epoch:
                busy += self._busy[i]
        return busy


class _StreamLedger:
    """Running attribution for one stream (mutated under the tracker
    lock; snapshot() hands out copies)."""

    __slots__ = ("device_ms", "by_kind", "batches", "frames",
                 "ema_ms_per_frame", "amortized_ms", "last_seen")

    def __init__(self):
        self.device_ms = 0.0          # total attributed device time
        self.by_kind: Dict[str, float] = {}
        self.batches = 0
        self.frames = 0
        self.ema_ms_per_frame: Optional[float] = None
        # Cadence-amortized running cost: full/roi shares land 1:1;
        # cascade head shares land divided by their dispatch cadence, so
        # this reads as the stream's steady-state cost per engine tick.
        self.amortized_ms = 0.0
        # Last attribution touch (tracker clock); drives departed-stream
        # expiry once a stream has been idle past the slow window (r21 —
        # the ledger dict must not grow without bound under churn).
        self.last_seen = 0.0


class _Cell:
    """One (model, geometry, bucket) serving cell's utilization ring."""

    __slots__ = ("ring", "busy_ms", "batches", "last_util")

    def __init__(self, slow_window_s: float, bin_s: float):
        self.ring = _BusyRing(slow_window_s, bin_s)
        self.busy_ms = 0.0
        self.batches = 0
        self.last_util = 0.0


class CapacityTracker:
    """Engine-owned capacity plane: ledger + rings + forecast + burn.

    ``note_batch`` is the attribution tap (drain thread, per device
    batch); ``evaluate`` is the forecast step (tick thread, throttled to
    ``eval_interval_s``); ``snapshot`` is the read surface. The clock is
    injectable so ramp/forecast math tests run sleep-free.
    """

    def __init__(self, *, tick_ms: int = 10,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 1800.0,
                 bin_s: float = 1.0,
                 util_objective: float = 0.8,
                 slope_alpha: float = 0.3,
                 eval_interval_s: float = 1.0,
                 clock=time.monotonic,
                 registry: Optional[metrics.Registry] = None):
        if not 0.0 < util_objective <= 1.0:
            raise ValueError(
                f"util_objective must be in (0, 1], got {util_objective}")
        if fast_window_s >= slow_window_s:
            raise ValueError(
                f"fast window ({fast_window_s}s) must be shorter than the "
                f"slow window ({slow_window_s}s)")
        self.tick_ms = int(tick_ms)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.bin_s = float(bin_s)
        self.util_objective = float(util_objective)
        self.slope_alpha = float(slope_alpha)
        self.eval_interval_s = float(eval_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: Optional[float] = None       # first attributed batch
        self._streams: Dict[str, _StreamLedger] = {}
        self._cells: Dict[Tuple[str, str, int], _Cell] = {}
        # Mesh-native serving (the JAX engine's): per-shard conservation ledgers.
        # Data-parallel replication means every chip is busy for the full
        # batch wall time, so a batch adds device_ms to EACH contributing
        # shard's measured AND attributed totals — per-shard drift is
        # 0.0 by construction, same as the aggregate.
        self._shards: Dict[str, Dict[str, float]] = {}
        self._agg = _BusyRing(slow_window_s, bin_s)
        # Conservation invariant state. The running totals are COUNTERS,
        # independent of the per-stream dict: expiring an idle stream's
        # ledger row (below) never unbalances them.
        self.attributed_ms = 0.0
        self.measured_ms = 0.0
        self.max_conservation_rel_err = 0.0
        # Departed-stream expiry (r21): rows idle past the slow window
        # are dropped from the live dict; their attributed totals are
        # folded into these aggregates so snapshot coverage stays whole.
        self.expired_streams = 0
        self.expired_ms = 0.0
        # Forecast state (updated only in evaluate()).
        self._next_eval = 0.0
        self._prev_util: Optional[float] = None
        self._prev_eval_t: Optional[float] = None
        self._slope_ema: Optional[float] = None   # utilization / second
        self._last: dict = {
            "utilization": {"fast": 0.0, "slow": 0.0},
            "burn": {"fast": 0.0, "slow": 0.0},
            "burning": False,
            "headroom": 1.0,
            "slope_per_s": None,
            "time_to_saturation_s": None,
        }
        reg = registry if registry is not None else metrics.registry
        self._m_stream_ms = reg.counter(
            "vep_capacity_stream_device_ms_total",
            "Attributed device time per stream (ms)", ("stream", "kind"))
        self._m_attr = reg.counter(
            "vep_capacity_attributed_ms_total",
            "Device time attributed to streams (conservation numerator)"
        ).labels()
        self._m_meas = reg.counter(
            "vep_capacity_measured_ms_total",
            "Device time measured per batch (conservation denominator)"
        ).labels()
        self._m_shard_attr = reg.counter(
            "vep_capacity_shard_attributed_ms_total",
            "Device time attributed per dp mesh shard (ms)", ("shard",))
        self._m_shard_meas = reg.counter(
            "vep_capacity_shard_measured_ms_total",
            "Device time measured per dp mesh shard (ms; replicated "
            "program — each chip busy the full batch)", ("shard",))
        self._m_util = reg.gauge(
            "vep_capacity_utilization",
            "Tick-budget utilization per burn window", ("window",))
        self._m_burn = reg.gauge(
            "vep_capacity_burn_rate",
            "Capacity burn multiple per window (utilization over the "
            "sustainable objective)", ("window",))
        self._m_headroom = reg.gauge(
            "vep_capacity_headroom",
            "Remaining utilization headroom in [0,1]").labels()
        self._m_tts = reg.gauge(
            "vep_capacity_time_to_saturation_seconds",
            "EWMA-slope saturation forecast (-1 = not saturating)"
        ).labels()
        self._m_cell_util = reg.gauge(
            "vep_capacity_cell_utilization",
            "Fast-window utilization per serving cell",
            ("model", "geometry", "bucket"))

    # -- attribution tap (drain thread) ---------------------------------

    def note_batch(self, model: str, src_hw: Tuple[int, int], bucket: int,
                   device_ms: float, streams: Sequence[str], *,
                   weights: Optional[Sequence[float]] = None,
                   kind: str = "full", amortize_n: int = 1,
                   shard_streams: Optional[Dict[str, Sequence[str]]] = None,
                   now: Optional[float] = None) -> None:
        """Attribute one measured device batch back to its occupant
        streams.

        ``streams``: the occupant stream ids (full-frame: one per real
        slot; ROI canvas: the distinct source streams). ``weights``:
        optional per-stream cost weights (ROI canvas-area shares);
        omitted = equal split. ``amortize_n``: dispatch cadence in ticks
        (cascade head = cfg.cascade_every_n) — raw cost lands in the
        ledger, cost/amortize_n in the steady-state per-tick figure.
        Conservation is exact BY CONSTRUCTION: the float residual of the
        share split is folded into the last share, so the attributed and
        measured running totals advance by the identical float — drift
        reads 0.0, not "within tolerance" (the multichip smoke gates the
        literal zero). The folded residual magnitude is still tracked as
        ``max_batch_rel_err``.

        Mesh-native serving: ``shard_streams`` maps dp shard label ->
        that shard's occupant streams for this batch. Replicated
        programs keep every chip busy for the full wall time, so each
        listed shard's measured AND attributed ledgers advance by the
        full ``device_ms`` (per-shard drift 0.0 by the same
        construction)."""
        now = self._clock() if now is None else now
        device_ms = float(device_ms)
        ids = list(streams) or [OVERHEAD_STREAM]
        if weights is not None and len(weights) == len(ids):
            wsum = float(sum(weights))
            shares = ([device_ms * float(w) / wsum for w in weights]
                      if wsum > 0.0
                      else [device_ms / len(ids)] * len(ids))
        else:
            shares = [device_ms / len(ids)] * len(ids)
        resid = device_ms - sum(shares)
        shares[-1] += resid
        attributed = device_ms
        rel_err = (abs(resid)
                   / max(abs(device_ms), 1e-12)) if device_ms else 0.0
        amortize = max(1, int(amortize_n))
        geometry = f"{src_hw[0]}x{src_hw[1]}"
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self.attributed_ms += attributed
            self.measured_ms += device_ms
            if rel_err > self.max_conservation_rel_err:
                self.max_conservation_rel_err = rel_err
            for sid, share in zip(ids, shares):
                led = self._streams.get(sid)
                if led is None:
                    led = self._streams[sid] = _StreamLedger()
                led.device_ms += share
                led.by_kind[kind] = led.by_kind.get(kind, 0.0) + share
                led.batches += 1
                led.frames += 1
                led.amortized_ms += share / amortize
                led.last_seen = now
                led.ema_ms_per_frame = (
                    share if led.ema_ms_per_frame is None
                    else 0.9 * led.ema_ms_per_frame + 0.1 * share)
            cell = self._cells.get((model, geometry, int(bucket)))
            if cell is None:
                cell = self._cells[(model, geometry, int(bucket))] = _Cell(
                    self.slow_window_s, self.bin_s)
            cell.ring.record(device_ms, now)
            cell.busy_ms += device_ms
            cell.batches += 1
            self._agg.record(device_ms, now)
            if shard_streams:
                for shard in shard_streams:
                    rec = self._shards.get(shard)
                    if rec is None:
                        rec = self._shards[shard] = {
                            "attributed": 0.0, "measured": 0.0}
                    rec["measured"] += device_ms
                    rec["attributed"] += device_ms
        for sid, share in zip(ids, shares):
            self._m_stream_ms.labels(sid, kind).inc(share)
        self._m_attr.inc(attributed)
        self._m_meas.inc(device_ms)
        if shard_streams:
            for shard in shard_streams:
                self._m_shard_attr.labels(str(shard)).inc(device_ms)
                self._m_shard_meas.labels(str(shard)).inc(device_ms)

    def note_coast(self, streams: Sequence[str]) -> None:
        """Register zero-cost occupants (MOSAIC gated-idle coast groups:
        no device work at all) so the ledger's stream coverage matches
        the serving set — a coasting stream reads as costing 0 ms, not
        as missing."""
        now = self._clock()
        with self._lock:
            for sid in streams:
                led = self._streams.get(sid)
                if led is None:
                    led = self._streams[sid] = _StreamLedger()
                led.batches += 1
                led.last_seen = now
                led.by_kind.setdefault("coast", 0.0)

    # -- forecast (tick thread, throttled) ------------------------------

    def _utilization(self, window_s: float, now: float) -> float:
        """Busy share of the elapsed window in [0, ...): busy device ms
        over window wall ms, windows clipped to the observed span so a
        young tracker is not diluted by bins it never lived through."""
        with self._lock:
            t0 = self._t0
            busy = self._agg.total(window_s, now)
        if t0 is None:
            return 0.0
        span_s = max(self.bin_s, min(window_s, now - t0 + self.bin_s))
        return busy / (span_s * 1000.0)

    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> dict:
        """Update the forecast + burn state from the rings; throttled to
        ``eval_interval_s`` unless forced. Returns the live state dict
        (also retained for snapshot())."""
        now = self._clock() if now is None else now
        if not force and now < self._next_eval:
            return self._last
        self._next_eval = now + self.eval_interval_s
        u_fast = self._utilization(self.fast_window_s, now)
        u_slow = self._utilization(self.slow_window_s, now)
        # EWMA utilization slope (per second): the forecast's trend
        # input. Evaluated on the fast window so ramps register within
        # a minute; the EMA keeps single noisy ticks from whipsawing
        # the saturation estimate.
        if self._prev_util is not None and self._prev_eval_t is not None \
                and now > self._prev_eval_t:
            slope = (u_fast - self._prev_util) / (now - self._prev_eval_t)
            self._slope_ema = (
                slope if self._slope_ema is None
                else self.slope_alpha * slope
                + (1.0 - self.slope_alpha) * self._slope_ema)
        self._prev_util = u_fast
        self._prev_eval_t = now
        headroom = max(0.0, 1.0 - u_fast)
        tts: Optional[float] = None
        if self._slope_ema is not None and self._slope_ema > 1e-9:
            tts = headroom / self._slope_ema
        burn_fast = u_fast / self.util_objective
        burn_slow = u_slow / self.util_objective
        burning = burn_fast > 1.0 and burn_slow > 1.0
        self._last = {
            "utilization": {"fast": u_fast, "slow": u_slow},
            "burn": {"fast": burn_fast, "slow": burn_slow},
            "burning": burning,
            "headroom": headroom,
            "slope_per_s": self._slope_ema,
            "time_to_saturation_s": tts,
        }
        self._m_util.labels("fast").set(u_fast)
        self._m_util.labels("slow").set(u_slow)
        self._m_burn.labels("fast").set(burn_fast)
        self._m_burn.labels("slow").set(burn_slow)
        self._m_headroom.set(headroom)
        self._m_tts.set(tts if tts is not None else -1.0)
        # Departed-stream expiry (r21): a stream idle past the slow
        # window has left the serving set (the engine stopped attributing
        # to it); its row no longer informs any live decision, so drop it
        # and fold its total into the expired aggregates. Conservation is
        # untouched — attributed_ms/measured_ms are running counters, not
        # sums over the live dict.
        with self._lock:
            cutoff = now - self.slow_window_s
            gone = [sid for sid, led in self._streams.items()
                    if led.last_seen < cutoff]
            for sid in gone:
                led = self._streams.pop(sid)
                self.expired_streams += 1
                self.expired_ms += led.device_ms
        with self._lock:
            cells = list(self._cells.items())
            t0 = self._t0
        span_s = max(self.bin_s, min(
            self.fast_window_s,
            (now - t0 + self.bin_s) if t0 is not None else self.bin_s))
        for (model, geometry, bucket), cell in cells:
            busy = cell.ring.total(self.fast_window_s, now)
            cell.last_util = busy / (span_s * 1000.0)
            self._m_cell_util.labels(
                model, geometry, str(bucket)).set(cell.last_util)
        return self._last

    # -- read surfaces ---------------------------------------------------

    def conservation(self) -> dict:
        """The ledger invariant's verdict: attributed vs measured device
        time, worst per-batch relative error, and whether the running
        totals agree within tolerance."""
        with self._lock:
            attributed = self.attributed_ms
            measured = self.measured_ms
            max_err = self.max_conservation_rel_err
            shard_recs = {s: dict(rec) for s, rec in self._shards.items()}
        drift = abs(attributed - measured) / max(measured, 1e-9) \
            if measured else 0.0
        out = {
            "attributed_ms": attributed,
            "measured_ms": measured,
            "rel_drift": drift,
            "max_batch_rel_err": max_err,
            "balanced": (drift <= CONSERVATION_REL_TOL
                         and max_err <= CONSERVATION_REL_TOL),
        }
        if shard_recs:
            out["shards"] = {
                s: {
                    "attributed_ms": rec["attributed"],
                    "measured_ms": rec["measured"],
                    "rel_drift": (abs(rec["attributed"] - rec["measured"])
                                  / max(rec["measured"], 1e-9)
                                  if rec["measured"] else 0.0),
                }
                for s, rec in sorted(shard_recs.items())
            }
        return out

    def streams(self) -> Dict[str, dict]:
        """Per-stream ledger rows (copies)."""
        with self._lock:
            return {
                sid: {
                    "device_ms": led.device_ms,
                    "by_kind": dict(led.by_kind),
                    "batches": led.batches,
                    "frames": led.frames,
                    "ema_ms_per_frame": led.ema_ms_per_frame,
                    "amortized_ms": led.amortized_ms,
                }
                for sid, led in self._streams.items()
            }

    def snapshot(self) -> dict:
        """JSON-able capacity state for /api/v1/capacity, the
        /api/v1/stats obs embed, and the fleet scrape. Runs a (throttled)
        evaluate so a read-only consumer still sees a live forecast."""
        state = self.evaluate()
        with self._lock:
            cells = {
                f"{model}|{geometry}|{bucket}": {
                    "busy_ms": round(cell.busy_ms, 3),
                    "batches": cell.batches,
                    "util_fast": round(cell.last_util, 6),
                }
                for (model, geometry, bucket), cell in self._cells.items()
            }
        return {
            "tick_ms": self.tick_ms,
            "util_objective": self.util_objective,
            "windows_s": {"fast": self.fast_window_s,
                          "slow": self.slow_window_s},
            "utilization": {k: round(v, 6)
                            for k, v in state["utilization"].items()},
            "burn": {k: round(v, 6) for k, v in state["burn"].items()},
            "burning": state["burning"],
            "headroom": round(state["headroom"], 6),
            "slope_per_s": state["slope_per_s"],
            "time_to_saturation_s": state["time_to_saturation_s"],
            "conservation": self.conservation(),
            "streams": self.streams(),
            "expired": {"streams": self.expired_streams,
                        "device_ms": round(self.expired_ms, 3)},
            "cells": cells,
        }

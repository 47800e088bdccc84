"""Output-quality observability (counterpart of
``video_edge_ai_proxy_tpu/obs/quality.py``): per-stream health verdicts
and detection drift scores.

:class:`QualityTracker` turns the device-computed frame statistics (luma
mean and variance, inter-frame thumbnail diff energy; ``ops/preprocess.py``
``frame_quality_stats``, folded into the serving step) and the emitted
detections into per-stream black / frozen / flatline / ok state machines
with time-based hysteresis (injectable clock), per-class detection-count
EMAs and log2 confidence histograms scored against a baseline (detection
drift), ``vep_quality_*`` metric families, and the ``unhealthy()`` set
the degradation ladder sheds first. ``observe()`` runs on the engine's
drain thread, ``unhealthy()`` on its tick thread; all state is
lock-guarded.

The canary integrity loop (``CanaryChecker``, off by default) is a later
slice.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence

from . import metrics as metrics_mod

log = logging.getLogger("vep.torch.obs.quality")

#: Verdicts in priority order — when several conditions hold at once the
#: earlier one wins (a black frame is also frozen; black explains more).
VERDICTS = ("black", "frozen", "flatline", "ok")

#: log2 confidence histogram: bin ``i`` holds scores in ``(2^-(i+1), 2^-i]``;
#: the last bin absorbs everything at or below ``2^-(CONF_BINS-1)``.
CONF_BINS = 8

#: A stream only flatlines if it historically detected at least this
#: per-frame count EMA — a stream that never detects anything is idle
#: scenery, not a failed head.
_FLATLINE_MIN_EMA = 0.5


def _conf_bin(score: float) -> int:
    """log2 bucket index for a confidence in (0, 1]."""
    s = float(score)
    if s >= 1.0:
        return 0
    if s <= 0.0:
        return CONF_BINS - 1
    return min(int(math.floor(-math.log2(s))), CONF_BINS - 1)


def _drift_score(base: dict, cur: dict) -> float:
    """Blend of confidence-histogram total-variation distance and mean
    relative per-class rate shift, clipped to [0, 1]. The 0.5 rate floor
    keeps a rare class (baseline ~0 per frame) from dominating."""
    hist_d = 0.5 * sum(abs(a - b) for a, b in zip(base["hist"], cur["hist"]))
    classes = set(base["rate"]) | set(cur["rate"])
    if classes:
        shift = sum(
            abs(cur["rate"].get(c, 0.0) - base["rate"].get(c, 0.0))
            / max(base["rate"].get(c, 0.0), 0.5)
            for c in classes
        ) / len(classes)
    else:
        shift = 0.0
    return min(1.0, 0.5 * hist_d + 0.5 * min(1.0, shift))


class _StreamState:
    __slots__ = (
        "verdict", "since", "samples", "cond_since", "clear_since",
        "luma", "luma_var", "diff", "last_det_t", "det_ema", "peak_det_ema",
        "class_ema", "win_hist", "win_counts", "win_frames", "win_start",
        "baseline", "drift", "drifting", "transitions", "drift_events",
    )

    def __init__(self, now: float):
        self.verdict = "ok"
        self.since = now
        self.samples = 0
        self.cond_since: Dict[str, float] = {}
        self.clear_since: Optional[float] = None
        self.luma: Optional[float] = None
        self.luma_var: Optional[float] = None
        self.diff: Optional[float] = None
        self.last_det_t: Optional[float] = None
        self.det_ema = 0.0
        self.peak_det_ema = 0.0
        self.class_ema: Dict[int, float] = {}
        self.win_hist = [0] * CONF_BINS
        self.win_counts: Dict[int, int] = {}
        self.win_frames = 0
        self.win_start = now
        self.baseline: Optional[dict] = None
        self.drift = 0.0
        self.drifting = False
        self.transitions: deque = deque(maxlen=64)
        self.drift_events: deque = deque(maxlen=32)


class QualityTracker:
    """Black / frozen / flatline / ok state machines + drift scoring.

    Hysteresis is time-based and symmetric: a condition must hold
    continuously for ``enter_s`` to enter a bad verdict, and EVERY
    condition must stay clear continuously for ``exit_s`` to return to
    ok — oscillation at either boundary resets the opposing run, so the
    verdict cannot flap.
    Flatline (zero detections for ``flatline_s`` on a stream that
    historically detected) carries its window in the condition itself
    and enters immediately once true.
    """

    def __init__(
        self,
        *,
        black_luma: float = 0.04,
        black_var: float = 5e-4,
        freeze_diff: float = 1e-6,
        enter_s: float = 2.0,
        exit_s: float = 2.0,
        flatline_s: float = 10.0,
        window_s: float = 5.0,
        drift_threshold: float = 0.35,
        ema_alpha: float = 0.05,
        baselines: Optional[Dict[str, dict]] = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[metrics_mod.Registry] = None,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ):
        self._black_luma = black_luma
        self._black_var = black_var
        self._freeze_diff = freeze_diff
        self._enter_s = enter_s
        self._exit_s = exit_s
        self._flatline_s = flatline_s
        self._window_s = window_s
        self._drift_threshold = drift_threshold
        self._ema_alpha = ema_alpha
        self._baselines = dict(baselines or {})
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._streams: Dict[str, _StreamState] = {}

        reg = registry if registry is not None else metrics_mod.registry
        self._g_state = reg.gauge(
            "vep_quality_state",
            "Per-stream health verdict (1 on the labeled verdict)",
            ("stream", "verdict"))
        self._c_trans = reg.counter(
            "vep_quality_transitions_total",
            "Quality verdict transitions per stream",
            ("stream", "verdict"))
        self._g_luma = reg.gauge(
            "vep_quality_luma",
            "Device-computed thumbnail-domain luma mean (0..1)",
            ("stream",))
        self._g_diff = reg.gauge(
            "vep_quality_diff_energy",
            "Device-computed inter-frame thumbnail MSE",
            ("stream",))
        self._g_drift = reg.gauge(
            "vep_quality_drift_score",
            "Detection drift vs baseline (0..1; histogram + rate blend)",
            ("stream",))
        self._g_unhealthy = reg.gauge(
            "vep_quality_unhealthy_streams",
            "Streams currently black, frozen or flatlined").labels()

    # -- hot path (drain thread) ------------------------------------------

    def observe(
        self,
        stream: str,
        *,
        luma_mean: Optional[float] = None,
        luma_var: Optional[float] = None,
        diff_energy: Optional[float] = None,
        classes: Sequence[int] = (),
        scores: Sequence[float] = (),
    ) -> str:
        """Fold one emitted frame's device stats + detections into the
        stream's state machine; returns the current verdict."""
        now = self._clock()
        fired = None
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                st = self._streams[stream] = _StreamState(now)
                st.baseline = self._baselines.get(stream)
            first = st.samples == 0
            st.samples += 1

            cur_luma = float(luma_mean) if luma_mean is not None else None
            cur_var = float(luma_var) if luma_var is not None else None
            # The first sample's diff is measured against the zero
            # thumbnail the device state starts from — meaningless either
            # way (a huge diff on a static scene, zero on a black one);
            # drop it so neither direction can mislead the state machine.
            cur_diff = (float(diff_energy)
                        if diff_energy is not None and not first else None)
            if cur_luma is not None:
                st.luma, st.luma_var = cur_luma, cur_var
                self._g_luma.labels(stream).set(cur_luma)
            if cur_diff is not None:
                st.diff = cur_diff
                self._g_diff.labels(stream).set(cur_diff)

            n_det = len(classes)
            a = self._ema_alpha
            st.det_ema += a * (n_det - st.det_ema)
            st.peak_det_ema = max(st.peak_det_ema, st.det_ema)
            counts: Dict[int, int] = {}
            for c in classes:
                counts[int(c)] = counts.get(int(c), 0) + 1
            for c in set(counts) | set(st.class_ema):
                prev = st.class_ema.get(c, 0.0)
                st.class_ema[c] = prev + a * (counts.get(c, 0) - prev)
            if n_det:
                st.last_det_t = now
            elif st.last_det_t is None:
                st.last_det_t = now  # flatline epoch for never-detected-yet

            for c, s in zip(classes, scores):
                st.win_counts[int(c)] = st.win_counts.get(int(c), 0) + 1
                st.win_hist[_conf_bin(s)] += 1
            st.win_frames += 1
            if now - st.win_start >= self._window_s and st.win_frames:
                self._roll_window(stream, st, now)
                st.win_start = now

            black = (cur_luma is not None and cur_luma < self._black_luma
                     and (cur_var is None or cur_var < self._black_var))
            frozen = cur_diff is not None and cur_diff < self._freeze_diff
            flatline = (not black and not frozen
                        and st.peak_det_ema >= _FLATLINE_MIN_EMA
                        and st.last_det_t is not None
                        and now - st.last_det_t >= self._flatline_s)

            for name, cond in (("black", black), ("frozen", frozen),
                               ("flatline", flatline)):
                if cond:
                    st.cond_since.setdefault(name, now)
                else:
                    st.cond_since.pop(name, None)

            candidate = None
            for name, need in (("black", self._enter_s),
                               ("frozen", self._enter_s),
                               ("flatline", 0.0)):
                t0 = st.cond_since.get(name)
                if t0 is not None and now - t0 >= need:
                    candidate = name
                    break

            if candidate is not None:
                st.clear_since = None
                if candidate != st.verdict:
                    fired = self._transition(stream, st, candidate, now)
            elif st.verdict != "ok":
                if black or frozen or flatline:
                    # Condition re-appeared before the exit window closed:
                    # restart the all-clear run (no flap back to ok).
                    st.clear_since = None
                else:
                    if st.clear_since is None:
                        st.clear_since = now
                    if now - st.clear_since >= self._exit_s:
                        fired = self._transition(stream, st, "ok", now)
                        st.clear_since = None
            self._g_unhealthy.set(sum(
                1 for s in self._streams.values() if s.verdict != "ok"))
            verdict = st.verdict
        if fired is not None:
            _, old, new = fired
            (log.info if new == "ok" else log.warning)(
                "stream %s quality verdict %s -> %s", stream, old, new)
            if self._on_transition is not None:
                try:
                    self._on_transition(stream, old, new)
                except Exception:
                    log.exception("quality transition callback failed")
        return verdict

    def _transition(self, stream: str, st: _StreamState, verdict: str,
                    now: float):
        old = st.verdict
        st.verdict = verdict
        st.since = now
        st.transitions.append((now, verdict))
        self._c_trans.labels(stream, verdict).inc()
        for v in VERDICTS:
            self._g_state.labels(stream, v).set(1.0 if v == verdict else 0.0)
        return (stream, old, verdict)

    def _roll_window(self, stream: str, st: _StreamState, now: float) -> None:
        total = sum(st.win_hist)
        cur = {
            "hist": ([h / total for h in st.win_hist] if total
                     else [0.0] * CONF_BINS),
            "rate": {c: n / st.win_frames
                     for c, n in st.win_counts.items()},
        }
        if st.baseline is None:
            if total:
                # Self-adopt: the first window that saw detections becomes
                # the reference distribution (committed replay-derived
                # baselines, when passed in, pre-empt this).
                st.baseline = cur
        else:
            st.drift = _drift_score(st.baseline, cur)
            self._g_drift.labels(stream).set(st.drift)
            was = st.drifting
            st.drifting = st.drift > self._drift_threshold
            if st.drifting and not was:
                st.drift_events.append((now, round(st.drift, 4)))
                log.warning("stream %s detection drift %.3f over threshold "
                            "%.3f", stream, st.drift, self._drift_threshold)
        st.win_hist = [0] * CONF_BINS
        st.win_counts = {}
        st.win_frames = 0

    # -- consumers (tick loop, snapshots) ---------------------------------

    def unhealthy(self) -> frozenset:
        """Streams the degradation ladder should shed first: black or
        frozen verdicts (flatline means the head went quiet, not that the
        frames are worthless — keep serving those)."""
        with self._lock:
            return frozenset(
                name for name, st in self._streams.items()
                if st.verdict in ("black", "frozen"))

    def verdict(self, stream: str) -> str:
        with self._lock:
            st = self._streams.get(stream)
            return st.verdict if st is not None else "ok"

    def forget(self, stream: str) -> None:
        """GC a removed stream's state (engine stream churn)."""
        with self._lock:
            self._streams.pop(stream, None)

    def reset(self) -> None:
        with self._lock:
            self._streams.clear()
            self._g_unhealthy.set(0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "config": {
                    "black_luma": self._black_luma,
                    "black_var": self._black_var,
                    "freeze_diff": self._freeze_diff,
                    "enter_s": self._enter_s,
                    "exit_s": self._exit_s,
                    "flatline_s": self._flatline_s,
                    "window_s": self._window_s,
                    "drift_threshold": self._drift_threshold,
                },
                "unhealthy": sorted(
                    name for name, st in self._streams.items()
                    if st.verdict != "ok"),
                "streams": {
                    name: {
                        "verdict": st.verdict,
                        "since": round(st.since, 3),
                        "samples": st.samples,
                        "luma": st.luma,
                        "luma_var": st.luma_var,
                        "diff_energy": st.diff,
                        "det_ema": round(st.det_ema, 3),
                        "drift": round(st.drift, 4),
                        "drifting": st.drifting,
                        "baseline": st.baseline is not None,
                        "transitions": [[round(t, 3), v]
                                        for t, v in st.transitions],
                        "drift_events": [[round(t, 3), d]
                                         for t, d in st.drift_events],
                    }
                    for name, st in sorted(self._streams.items())
                },
            }

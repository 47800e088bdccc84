"""Threshold crossings logged once per episode (counterpart of
``video_edge_ai_proxy_tpu/obs/watch.py``).

A stalled drain, a recompile storm, a degraded ladder, an SLO burn, a
breaker stuck open or a canary mismatch each becomes ONE warning when its
threshold is crossed and ONE info line when it recovers: hysteresis by
episode, so a value oscillating around the threshold cannot flood the log.
``check`` is called from an existing periodic path (the engine tick); the
watchdog owns no thread. ``snapshot()`` exports the active episodes and the
totals for ``/api/v1/stats``. With a journal, every open and close is also
a decision event.

Pure Python.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("vep.torch.obs.watch")


class Watchdog:
    """Once-per-episode threshold monitor.

    ``check(name, value, above=x)`` opens an episode (and logs WARNING)
    the first time ``value > x``; subsequent breaching checks are silent;
    the first non-breaching check closes the episode (and logs INFO with
    the episode duration and peak). ``below=`` watches the other
    direction (e.g. batch occupancy collapsing).

    ``journal`` (optional ``obs.journal.DecisionJournal``): every
    episode open/close is recorded as a decision event whose trigger
    carries the excursion magnitude (value/threshold on open, peak and
    duration on close) so downstream cause links explain HOW BAD the
    crossing was, not just that it happened.
    """

    def __init__(self, *, journal=None):
        self._lock = threading.Lock()
        self.journal = journal
        # name -> {since, peak, threshold, direction, detail, seq}
        self._active: Dict[str, dict] = {}
        self._episodes: Dict[str, int] = {}
        # name -> most recent COMPLETED episode (open ts + peak survive
        # the close: totals alone cannot tell a journal
        # event the excursion magnitude).
        self._last: Dict[str, dict] = {}

    def check(self, name: str, value: float, *,
              above: Optional[float] = None,
              below: Optional[float] = None,
              detail: str = "") -> bool:
        """Evaluate one condition; returns True while breaching."""
        if (above is None) == (below is None):
            raise ValueError("exactly one of above=/below= required")
        breach = value > above if above is not None else value < below
        threshold = above if above is not None else below
        direction = "above" if above is not None else "below"
        now = time.time()
        opened = closed = None
        with self._lock:
            ep = self._active.get(name)
            if breach:
                if ep is None:
                    ep = {
                        "since": now,
                        "peak": value,
                        "threshold": threshold,
                        "direction": direction,
                        "detail": detail,
                        "seq": None,
                    }
                    self._active[name] = ep
                    self._episodes[name] = self._episodes.get(name, 0) + 1
                    opened = ep
                else:
                    if above is not None:
                        ep["peak"] = max(ep["peak"], value)
                    else:
                        ep["peak"] = min(ep["peak"], value)
            elif ep is not None:
                del self._active[name]
                self._last[name] = {
                    "opened": ep["since"],
                    "closed": now,
                    "duration_s": round(now - ep["since"], 3),
                    "peak": ep["peak"],
                    "threshold": ep["threshold"],
                    "direction": ep["direction"],
                }
                closed = ep
        # Journal + log OUTSIDE the lock (the journal has its own).
        if opened is not None:
            seq = None
            if self.journal is not None:
                seq = self.journal.record(
                    "watch", "episode_open", subject=("watch", name),
                    trigger={"value": float(value),
                             "threshold": float(threshold),
                             "direction": direction})
                opened["seq"] = seq
            log.warning(
                "watch: %s %s threshold %g (value %g)%s",
                name, direction, threshold, value,
                f" — {detail}" if detail else "",
                extra={"vep_actor": "watch",
                       "vep_subject": f"watch:{name}",
                       "vep_journal_seq": seq},
            )
        elif closed is not None:
            seq = None
            if self.journal is not None:
                seq = self.journal.record(
                    "watch", "episode_close", subject=("watch", name),
                    trigger={"peak": float(closed["peak"]),
                             "threshold": float(closed["threshold"]),
                             "duration_s": round(now - closed["since"], 3)},
                    cause=closed.get("seq"))
            log.info(
                "watch: %s recovered after %.1fs (peak %g, "
                "threshold %g)",
                name, now - closed["since"], closed["peak"],
                closed["threshold"],
                extra={"vep_actor": "watch",
                       "vep_subject": f"watch:{name}",
                       "vep_journal_seq": seq},
            )
        return breach

    def active(self) -> Dict[str, dict]:
        with self._lock:
            return {
                k: {**v, "age_s": round(time.time() - v["since"], 1)}
                for k, v in self._active.items()
            }

    def snapshot(self) -> dict:
        """JSON-able state for ``/api/v1/stats``."""
        with self._lock:
            active = {
                k: {
                    "since": v["since"],
                    "age_s": round(time.time() - v["since"], 1),
                    "peak": v["peak"],
                    "threshold": v["threshold"],
                    "direction": v["direction"],
                    "detail": v["detail"],
                    "seq": v.get("seq"),
                }
                for k, v in self._active.items()
            }
            return {"active": active, "episodes": dict(self._episodes),
                    "last": {k: dict(v) for k, v in self._last.items()}}

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._episodes.clear()
            self._last.clear()

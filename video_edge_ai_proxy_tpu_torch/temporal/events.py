"""Per-track event hysteresis of the temporal cascade (counterpart of
``video_edge_ai_proxy_tpu/temporal/events.py``).

A track's anomaly score must clear the threshold on ``enter_n``
consecutive cascade observations before "enter" fires, and stay below it
on ``exit_n`` consecutive ones before the matching "exit"; a score that
flaps across the threshold resets the run and fires nothing. Counts, not
seconds: observations come one a head pass, every ``cascade_every_n``
ticks, so a wall-clock debounce would alias against the cadence. A
transition fires only when the active flag flips, so each boundary gives
exactly one event however long the condition holds.

Plain Python with no locking: the owning scheduler serialises access.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class TrackEventTracker:
    """Enter/exit hysteresis state machines keyed by track."""

    __slots__ = ("threshold", "enter_n", "exit_n", "_state")

    def __init__(self, threshold: float = 0.5, enter_n: int = 2, exit_n: int = 2):
        self.threshold = float(threshold)
        self.enter_n = max(1, int(enter_n))
        self.exit_n = max(1, int(exit_n))
        # key -> [active, consecutive run toward the opposite state]
        self._state: Dict[str, list] = {}

    def observe(self, key: str, score: float) -> Optional[str]:
        """Feed one observation; "enter"/"exit" when the track transitions,
        else None."""
        st = self._state.setdefault(key, [False, 0])
        hot = float(score) >= self.threshold
        if st[0] == hot:
            # The current state confirmed: a partial run toward the other
            # state was a flap.
            st[1] = 0
            return None
        st[1] += 1
        if st[1] < (self.enter_n if hot else self.exit_n):
            return None
        st[0] = hot
        st[1] = 0
        return "enter" if hot else "exit"

    def active(self, key: str) -> bool:
        st = self._state.get(key)
        return bool(st and st[0])

    def active_keys(self) -> List[str]:
        return [k for k, st in self._state.items() if st[0]]

    def pop(self, key: str, default=None):
        """Drop a track's machine (the track expired or its stream went). A
        key that comes back starts cold; the removal fires nothing."""
        return self._state.pop(key, default)

    def __len__(self) -> int:
        return len(self._state)

    def __contains__(self, key: str) -> bool:
        return key in self._state

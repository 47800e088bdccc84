"""Scripted fault plans for chaos soaks (counterpart of
``video_edge_ai_proxy_tpu/replay/faults.py``, the same kinds, windows and
JSON).

A ``FaultPlan`` is a deterministic, time-ordered script of pipeline
faults: the chaos of a soak is one of its inputs, not a random draw, so a
failing soak replays exactly. The kinds and what injects them
(``replay/harness.py`` ``run_fleet_soak``):

- ``camera_kill`` / ``camera_restore``: stop a camera's publisher and drop
  its bus stream, then re-add it (the collector's cursors, the trackers'
  and the emit policies' state must survive the churn).
- ``frame_gap``: suppress one camera's publishes for ``duration_s``.
- ``bus_stall``: delay every publish for ``duration_s``.
- ``slow_subscriber``: stop draining the result subscription for
  ``duration_s`` (the engine drops and counts, ``subscriber_drops``).
- ``uplink_down``: every annotation POST fails for ``duration_s`` (retry,
  breaker, dead-letter spool, drained on recovery).
- ``bus_flap``: publishes raise ``ConnectionError`` for ``duration_s``.
- ``device_stall``: every serving step call slows for ``duration_s`` (the
  degradation ladder must escalate, then recover).
- ``black_frame`` / ``frozen_frame``: one camera publishes all-zero frames
  / the same frame for ``duration_s`` (a quality verdict must fire).
- ``score_drift``: every detect step's scores are scaled down for
  ``duration_s`` (the canary must mismatch).
- ``shard_fault``: one mesh slot's step fails hard from ``at_s`` on (or,
  with ``duration_s`` > 0, its drains stall), ``device_id`` naming the
  slot index; ``ShardFaultInjector`` injects it into a live engine (the
  device-fault domain must detect, fail over to the survivor mesh and
  conserve every frame).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import List, Optional

KINDS = (
    "camera_kill", "camera_restore", "frame_gap", "bus_stall",
    "slow_subscriber", "uplink_down", "bus_flap", "device_stall",
    "black_frame", "frozen_frame", "score_drift", "shard_fault",
)

#: Schedule template for the resilience kinds (fraction of the soak
#: window: start, duration) — disjoint windows, each with recovery slack
#: before the next, so the artifact attributes effects to causes.
_RESILIENCE_WINDOWS = {
    "uplink_down": (0.15, 0.20),
    "bus_flap": (0.50, 0.06),
    "device_stall": (0.62, 0.15),
}

#: The kinds `tools/torch_soak_replay.py --faults` may select (the churn kinds
#: need per-device scheduling and run via default_churn instead).
RESILIENCE_KINDS = tuple(_RESILIENCE_WINDOWS)

#: Schedule template for the output-quality kinds: black and
#: frozen run on DISTINCT cameras (per-device targeting), drift is
#: global (a step-wrapper perturbation), so their windows may overlap —
#: but they stay disjoint anyway so the detection-latency gate in
#: tools/torch_soak_replay.py attributes each verdict to one cause, and each
#: window leaves recovery slack for the exit-hysteresis to clear.
#: score_drift gets the widest slot: the canary judges integrity one
#: full checksum cycle at a time (loop_len / canary fps ≈ 3 s in the
#: soak harness), so the drift must stay up long enough for at least
#: one complete cycle — ideally two — to close inside it.
_QUALITY_WINDOWS = {
    "black_frame": (0.10, 0.20),
    "frozen_frame": (0.35, 0.20),
    "score_drift": (0.58, 0.35),
}

QUALITY_KINDS = tuple(_QUALITY_WINDOWS)


@dataclass(order=True)
class FaultEvent:
    at_s: float                 # seconds from soak start
    kind: str = field(compare=False)
    device_id: str = field(default="", compare=False)
    duration_s: float = field(default=0.0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """Time-ordered fault script with a cursor (pop_due)."""

    def __init__(self, events=()):
        self.events = sorted(events)
        self._i = 0

    def reset(self) -> None:
        self._i = 0

    def pop_due(self, now_s: float) -> list[FaultEvent]:
        """Events whose time has come since the last call (monotone)."""
        due = []
        while self._i < len(self.events) and \
                self.events[self._i].at_s <= now_s:
            due.append(self.events[self._i])
            self._i += 1
        return due

    def to_json(self) -> str:
        return json.dumps([asdict(e) for e in self.events], indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls([FaultEvent(**e) for e in json.loads(text)])

    @classmethod
    def default_churn(
        cls, device_ids, duration_s: float,
    ) -> "FaultPlan":
        """The acceptance-run script, scaled to the soak window: one
        camera killed at 25% and re-added at 55% (churn across a long gap
        — its collector/tracker state must GC and rebuild), a frame-gap
        burst on a second camera, one global bus stall, and one
        slow-subscriber window — each in its own quiet period so the
        artifact attributes effects to causes."""
        devs = sorted(device_ids)
        ev = []
        if devs:
            ev += [
                FaultEvent(at_s=duration_s * 0.25, kind="camera_kill",
                           device_id=devs[0]),
                FaultEvent(at_s=duration_s * 0.55, kind="camera_restore",
                           device_id=devs[0]),
            ]
        if len(devs) > 1:
            ev.append(FaultEvent(
                at_s=duration_s * 0.35, kind="frame_gap",
                device_id=devs[-1],
                duration_s=max(2.0, duration_s * 0.05)))
        ev.append(FaultEvent(
            at_s=duration_s * 0.70, kind="bus_stall",
            duration_s=max(1.0, duration_s * 0.02)))
        ev.append(FaultEvent(
            at_s=duration_s * 0.85, kind="slow_subscriber",
            duration_s=max(2.0, duration_s * 0.05)))
        return cls(ev)

    @classmethod
    def resilience(
        cls, duration_s: float, kinds=("uplink_down", "bus_flap",
                                       "device_stall"),
    ) -> "FaultPlan":
        """The chaos-smoke script: the three resilience fault kinds in
        disjoint windows scaled to the soak length
        (``tools/torch_soak_replay.py --faults`` selects)."""
        ev = []
        for kind in kinds:
            if kind not in _RESILIENCE_WINDOWS:
                raise ValueError(
                    f"not a resilience fault kind: {kind!r} "
                    f"(choose from {sorted(_RESILIENCE_WINDOWS)})"
                )
            frac, dur = _RESILIENCE_WINDOWS[kind]
            ev.append(FaultEvent(
                at_s=duration_s * frac, kind=kind,
                duration_s=max(1.0, duration_s * dur),
            ))
        return cls(ev)

    @classmethod
    def quality(
        cls, duration_s: float, device_ids,
        kinds=QUALITY_KINDS,
    ) -> "FaultPlan":
        """The quality-smoke script: black on the first camera, frozen
        on the second (distinct targets — both verdicts must fire
        independently), score_drift global, each in its _QUALITY_WINDOWS
        slot scaled to the soak length."""
        devs = sorted(device_ids)
        if not devs:
            raise ValueError("quality fault plan needs at least one camera")
        target = {
            "black_frame": devs[0],
            "frozen_frame": devs[1 % len(devs)],
            "score_drift": "",
        }
        ev = []
        for kind in kinds:
            if kind not in _QUALITY_WINDOWS:
                raise ValueError(
                    f"not a quality fault kind: {kind!r} "
                    f"(choose from {sorted(_QUALITY_WINDOWS)})"
                )
            frac, dur = _QUALITY_WINDOWS[kind]
            ev.append(FaultEvent(
                at_s=duration_s * frac, kind=kind,
                device_id=target[kind],
                duration_s=max(1.0, duration_s * dur),
            ))
        return cls(ev)


class ShardFaultInjector:
    """The ``shard_fault`` kind on a live engine, as the JAX package's chaos
    smoke injects it. ``fire(event)``:

    - hard (``duration_s`` 0): the engine's next step lookup raises an
      error that carries ``fault_shard`` (what a device error attributed
      to a slot looks like), once; ``tick`` and ``ts`` record when;
    - stall (``duration_s`` > 0): the fault plane's dispatch deadline
      drops to 0.01 ms, so the drain's hysteresis opens a stall suspicion
      on real batches, and its probe is scripted to name the slot (a slot
      on a healthy device cannot be made to wedge); ``restore()`` puts
      the configured deadline back once the failover is done.

    Installed by construction (it wraps ``engine._step``); ``remove()``
    unwraps it."""

    def __init__(self, engine):
        self.engine = engine
        self._orig_step = engine._step
        self._armed: Optional[int] = None
        self._votes: List[int] = []
        self.shard: Optional[int] = None
        self.tick: Optional[int] = None
        self.ts: Optional[float] = None
        engine._step = self._step

    def _step(self, src_hw, bucket, model=None):
        if self._armed is not None:
            shard, self._armed = self._armed, None
            self.tick = self.engine.ticks
            self.ts = time.monotonic()
            exc = RuntimeError(f"injected shard_fault: device of shard {shard} halted")
            exc.fault_shard = shard
            raise exc
        return self._orig_step(src_hw, bucket, model)

    def _probe(self) -> List[int]:
        return [self._votes.pop()] if self._votes else []

    def fire(self, event: "FaultEvent") -> None:
        shard = int(event.device_id)
        if event.duration_s > 0:
            self._votes.append(shard)
            self.engine.faults.probe_fn = self._probe
            self.engine.faults.deadline_ms = 0.01
        else:
            self.shard = shard
            self._armed = shard

    def restore(self) -> None:
        """The configured dispatch deadline back (after a stall's failover)."""
        self.engine.faults.deadline_ms = self.engine._cfg.fault_dispatch_deadline_ms

    def remove(self) -> None:
        self.engine._step = self._orig_step

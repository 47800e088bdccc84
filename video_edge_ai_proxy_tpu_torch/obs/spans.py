"""Per-frame lineage tracing (counterpart of
``video_edge_ai_proxy_tpu/obs/spans.py``): sampled span events in
per-stream rings, and the frame's trace id.

A frame's identity is its packet number stamped at ingest
(``FrameMeta.packet``), keyed by device id. Stages record span events as
the frame flows worker -> bus -> collector -> engine submit -> device ->
result emit. Sampling is 1 in N on the frame id, so the SAME frames are
sampled at every stage and spans join into lineages; ``sampled`` is one
modulo and an attribute read, and with tracing off a boolean test.

Stages:

- ``publish``: the ingest worker wrote the frame to the bus (in the
  worker's process; the collect span carries ``pub_ms``, the frame's
  publish stamp, so the ingest -> collect leg is computable from the
  engine's side alone);
- ``collect``: the engine's collector read the frame off the bus;
- ``submit``: the frame's batch was queued on the device;
- ``device``: the step drained; ``dur_ms`` is its device time;
- ``emit``: the result was published;
- ``dropped``: terminal, the frame left without a result (shed stale,
  dropped at shutdown, a batch that failed), so a lineage never stays
  open.

Every span carries ``trace_id=``, the frame's wire trace id
(``trace_id_for``, stamped by the worker at publish), so fragments from
several processes join into one trace. ``to_chrome_trace`` exports events
as Chrome trace-event JSON (chrome://tracing, Perfetto);
``stage_breakdown`` folds them into the per-leg latency table that
``/api/v1/trace`` serves.

Pure Python. Timestamps are ``time.time()`` seconds, so they align with
``FrameMeta.timestamp_ms`` across processes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

STAGES = ("publish", "collect", "submit", "device", "emit", "dropped")

# Latency legs derivable from a complete lineage, in pipeline order.
LEGS = ("ingest_bus", "batch", "device", "emit", "total")

# FNV-1a 64-bit, masked to 63 bits so the id fits every carrier on the
# wire (C int64 in the shm FrameMeta, protobuf int64, JSON) without sign
# surprises.
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_TRACE_MASK = 0x7FFF_FFFF_FFFF_FFFF


def trace_id_for(stream: str, frame_id: int) -> int:
    """Deterministic per-frame trace id: FNV-1a over ``stream:frame``.

    Content-derived (not random) so a replayed trace produces the SAME
    ids run-over-run — replay checksums stay bit-identical with fleet
    telemetry enabled — while ids from different streams/processes land
    in disjoint ranges with high probability. Never returns 0 (0 on the
    wire means "unstamped", and consumers re-derive)."""
    h = _FNV_OFFSET
    for b in f"{stream}:{int(frame_id)}".encode():
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return (h & _TRACE_MASK) or 1


def trace_id_of(meta, stream: str) -> int:
    """The frame's wire trace id, deriving it for unstamped (non-worker)
    producers so every consumer agrees on the same id."""
    tid = int(getattr(meta, "trace_id", 0) or 0)
    return tid if tid else trace_id_for(stream, getattr(meta, "packet", 0))


class SpanRecorder:
    """Thread-safe sampled span sink with per-stream ring buffers.

    Disabled by default: serving imports this at module load, but tracing
    only turns on when the server/harness calls ``configure``. ``sampled``
    is the hot-path gate — call sites do ``if tracer.sampled(fid): ...``
    so the span-dict build is skipped entirely for unsampled frames.
    """

    def __init__(self, sample_every: int = 16, ring: int = 1024,
                 enabled: bool = False):
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {}
        self.sample_every = max(1, int(sample_every))
        self.ring = int(ring)
        self.enabled = bool(enabled)

    def configure(self, *, enabled: Optional[bool] = None,
                  sample_every: Optional[int] = None,
                  ring: Optional[int] = None) -> None:
        if sample_every is not None:
            self.sample_every = max(1, int(sample_every))
        if ring is not None and int(ring) != self.ring:
            self.ring = int(ring)
            with self._lock:
                self._rings = {
                    k: deque(v, maxlen=self.ring)
                    for k, v in self._rings.items()
                }
        if enabled is not None:
            self.enabled = bool(enabled)

    def sampled(self, frame_id: int) -> bool:
        """Deterministic 1-in-N gate; same verdict at every stage."""
        return self.enabled and (int(frame_id) % self.sample_every == 0)

    def record(self, stream: str, stage: str, frame_id: int,
               ts: Optional[float] = None, dur_ms: Optional[float] = None,
               **extra) -> None:
        """Append one span event. ``ts`` = wall-clock seconds at span END
        (defaults to now); ``dur_ms`` = span duration when known."""
        ev = {
            "stream": stream,
            "stage": stage,
            "frame": int(frame_id),
            "ts": time.time() if ts is None else float(ts),
        }
        if dur_ms is not None:
            ev["dur_ms"] = round(float(dur_ms), 4)
        if extra:
            ev.update(extra)
        with self._lock:
            ring = self._rings.get(stream)
            if ring is None:
                ring = deque(maxlen=self.ring)
                self._rings[stream] = ring
            ring.append(ev)

    def events(self, stream: Optional[str] = None,
               limit: Optional[int] = None) -> List[dict]:
        """Snapshot of buffered events (oldest first), optionally one
        stream, optionally the most recent ``limit`` per stream."""
        with self._lock:
            if stream is not None:
                evs = list(self._rings.get(stream, ()))
                if limit:
                    evs = evs[-limit:]
                return evs
            out: List[dict] = []
            for ring in self._rings.values():
                evs = list(ring)
                if limit:
                    evs = evs[-limit:]
                out.extend(evs)
        out.sort(key=lambda e: e["ts"])
        return out

    def streams(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()


# THE process-wide tracer (mirrors ``metrics.registry``). The server and
# the replay harness call ``tracer.configure(enabled=True, ...)``.
tracer = SpanRecorder()


def _lineages(events: Iterable[dict]) -> Dict[tuple, Dict[str, dict]]:
    """Group events by (stream, frame) -> {stage: latest event}."""
    by_frame: Dict[tuple, Dict[str, dict]] = {}
    for ev in events:
        key = (ev.get("stream"), ev.get("frame"))
        by_frame.setdefault(key, {})[ev.get("stage")] = ev
    return by_frame


def _leg_stats(samples: List[float]) -> dict:
    n = len(samples)
    if n == 0:
        return {"count": 0, "avg": None, "p50": None, "p90": None,
                "p99": None}
    s = sorted(samples)

    def q(p: float) -> float:
        idx = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
        return round(s[idx], 3)

    return {"count": n, "avg": round(sum(s) / n, 3), "p50": q(50),
            "p90": q(90), "p99": q(99)}


def stage_breakdown(events: Iterable[dict]) -> dict:
    """Fold span events into per-leg latency stats (ms).

    Legs::

        ingest_bus  publish stamp (pub_ms on the collect span, or the
                    publish span's ts) -> collected off the bus
        batch       collected -> batch submitted to the device thread
        device      device span dur_ms (the drained step)
        emit        device drain end -> result emitted
        total       publish stamp -> result emitted

    Partial lineages contribute whichever legs they can; a frame sampled
    mid-flight (ring rolled over) just has fewer legs. Lineages closed by
    a terminal ``dropped`` span (shed, shutdown, a failed batch) are
    counted under ``drops`` by reason
    instead of silently reading as still-in-flight.
    """
    legs: Dict[str, List[float]] = {leg: [] for leg in LEGS}
    drops: Dict[str, int] = {}
    dropped_total = 0
    for (_, _), stages in _lineages(events).items():
        dropped = stages.get("dropped")
        if dropped is not None:
            dropped_total += 1
            reason = str(dropped.get("reason", "unknown"))
            drops[reason] = drops.get(reason, 0) + 1
        collect = stages.get("collect")
        submit = stages.get("submit")
        device = stages.get("device")
        emit = stages.get("emit")
        publish = stages.get("publish")
        pub_ms = None
        if collect is not None and collect.get("pub_ms") is not None:
            pub_ms = float(collect["pub_ms"])
        elif publish is not None:
            pub_ms = publish["ts"] * 1000.0
        if pub_ms is not None and collect is not None:
            legs["ingest_bus"].append(collect["ts"] * 1000.0 - pub_ms)
        if collect is not None and submit is not None:
            legs["batch"].append((submit["ts"] - collect["ts"]) * 1000.0)
        if device is not None and device.get("dur_ms") is not None:
            legs["device"].append(float(device["dur_ms"]))
        if device is not None and emit is not None:
            legs["emit"].append((emit["ts"] - device["ts"]) * 1000.0)
        if pub_ms is not None and emit is not None:
            legs["total"].append(emit["ts"] * 1000.0 - pub_ms)
    out = {leg: _leg_stats(vals) for leg, vals in legs.items()}
    out["drops"] = {"count": dropped_total,
                    "by_reason": dict(sorted(drops.items()))}
    return out


def to_chrome_trace(events: Iterable[dict], pid: int = 1,
                    process_name: str = "video-edge-ai-proxy-tpu") -> dict:
    """Convert span events to Chrome trace-event JSON (the object; dump
    with ``json.dump``). One trace thread per stream; spans with dur_ms
    become complete events (ph "X", ts = span start), the rest instants
    (ph "i"). Loadable in chrome://tracing and Perfetto.

    ``pid``/``process_name`` namespace the host track, so several engines'
    exports can share one timeline without track collisions.
    """
    events = list(events)
    tids: Dict[str, int] = {}
    trace: List[dict] = []
    for ev in events:
        stream = str(ev.get("stream", "?"))
        if stream not in tids:
            tids[stream] = len(tids) + 1
            trace.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tids[stream], "args": {"name": f"stream {stream}"},
            })
    trace.insert(0, {
        "ph": "M", "name": "process_name", "pid": pid,
        "args": {"name": process_name},
    })
    for ev in events:
        stream = str(ev.get("stream", "?"))
        args = {k: v for k, v in ev.items()
                if k not in ("stream", "stage", "ts", "dur_ms")}
        dur_ms = ev.get("dur_ms")
        end_us = ev["ts"] * 1e6
        base = {
            "name": ev.get("stage", "?"),
            "cat": "frame",
            "pid": pid,
            "tid": tids[stream],
            "args": args,
        }
        if dur_ms is not None:
            dur_us = float(dur_ms) * 1000.0
            base.update(ph="X", ts=round(end_us - dur_us, 3),
                        dur=round(dur_us, 3))
        else:
            base.update(ph="i", ts=round(end_us, 3), s="t")
        trace.append(base)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj) -> List[str]:
    """Schema-check a Chrome trace-event JSON object. Returns problems
    (empty = loadable)."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing traceEvents array"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            problems.append(f"event {i}: missing ph")
            continue
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"event {i}: ph={ph} missing numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: complete event missing dur")
        if "name" not in ev:
            problems.append(f"event {i}: missing name")
        if ph != "M" and not isinstance(ev.get("pid"), int):
            problems.append(f"event {i}: missing integer pid")
    return problems

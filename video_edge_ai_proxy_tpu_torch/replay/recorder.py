"""Flight-recorder taps (counterpart of ``video_edge_ai_proxy_tpu/replay/recorder.py``).

- :class:`RecordingBus` wraps any FrameBus and records every ``publish``
  into a trace (the bus publish tap for in-process pipelines).
- :class:`TraceRecorder` is the thread-safe facade over the writer with
  per-stream bookkeeping.
- ``record_synthetic_trace`` writes a trace directly, no pipeline needed:
  the deterministic traffic generator, with exact fps-grid arrival times,
  so two recordings of the same spec are identical files (but for the
  header's timestamp).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from .trace import TraceWriter


class TraceRecorder:
    """Thread-safe facade over TraceWriter with per-stream bookkeeping."""

    def __init__(self, path: str):
        self._w = TraceWriter(path)
        self._lock = threading.Lock()
        self._streams: set[str] = set()

    @property
    def path(self) -> str:
        return self._w.path

    def record_stream(
        self, device_id: str, *, width: int, height: int,
        fps: float = 0.0, gop: int = 0, kind: str = "",
    ) -> None:
        with self._lock:
            if device_id in self._streams:
                return
            self._streams.add(device_id)
        self._w.stream_event(
            device_id, width=width, height=height, fps=fps, gop=gop,
            kind=kind)

    def record_frame(
        self, device_id: str, frame: np.ndarray, meta,
        synth: Optional[dict] = None,
    ) -> None:
        """One published frame. ``meta`` is a bus FrameMeta (or anything
        with pts/dts/is_keyframe/packet/timestamp_ms/time_base). ``synth``
        = {"w","h","n"} replaces the payload with a pattern seed."""
        if device_id not in self._streams:
            self.record_stream(
                device_id, width=frame.shape[1], height=frame.shape[0])
        self._w.frame_event(
            device_id,
            pts=getattr(meta, "pts", 0),
            dts=getattr(meta, "dts", 0),
            is_keyframe=bool(getattr(meta, "is_keyframe", False)),
            packet=int(getattr(meta, "packet", 0)),
            timestamp_ms=int(getattr(meta, "timestamp_ms", 0)),
            time_base=float(getattr(meta, "time_base", 1.0 / 90000.0)),
            synth=synth,
            frame=None if synth is not None else frame,
        )

    def close(self) -> None:
        self._w.close()


class RecordingBus:
    """FrameBus proxy that records every publish into a trace — the bus
    publish tap. Everything else (reads, KV, doorbell) delegates
    untouched, so it drops in anywhere a FrameBus goes."""

    def __init__(self, bus, recorder: TraceRecorder,
                 synth_of: Optional[callable] = None):
        self._bus = bus
        self._recorder = recorder
        # synth_of(device_id, meta) -> {"w","h","n"} | None: lets callers
        # that KNOW their frames are synthetic (a pattern generator) store seeds
        # instead of payloads.
        self._synth_of = synth_of

    def __getattr__(self, name):
        return getattr(self._bus, name)

    def publish(self, device_id: str, frame, meta) -> int:
        synth = self._synth_of(device_id, meta) if self._synth_of else None
        self._recorder.record_frame(device_id, frame, meta, synth=synth)
        return self._bus.publish(device_id, frame, meta)


def record_synthetic_trace(
    path: str, device_ids, *, width: int, height: int, fps: float = 30.0,
    gop: int = 30, frames: int = 300, start_ms: int = 1_700_000_000_000,
) -> str:
    """Write a deterministic multi-camera trace of SyntheticSource
    traffic without running any pipeline: frame n of camera i arrives at
    t = n/fps (all cameras in phase, like a fleet of genlocked test
    cameras), pts on the 90 kHz grid, keyframes every ``gop``. Epoch
    timestamps start at the fixed ``start_ms`` so two recordings of the
    same spec replay identically."""
    w = TraceWriter(path)
    # Bypass the wall clock entirely: events carry computed t_ms.
    for device_id in device_ids:
        w.append({
            "ev": "stream", "device": device_id, "t_ms": 0.0,
            "w": int(width), "h": int(height), "fps": float(fps),
            "gop": int(gop), "kind": "synthetic",
        })
    for n in range(frames):
        t_ms = round(n * 1000.0 / fps, 3)
        pts = int(n * 90000 / fps)
        for device_id in device_ids:
            w.append({
                "ev": "frame", "device": device_id, "t_ms": t_ms,
                "pts": pts, "dts": pts, "key": (n % gop == 0),
                "packet": n, "ts_ms": int(start_ms + t_ms),
                "tb": 1.0 / 90000.0,
                "synth": {"w": int(width), "h": int(height), "n": n},
            })
    w.close()
    return path

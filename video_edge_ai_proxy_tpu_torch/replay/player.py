"""Trace replay (counterpart of ``video_edge_ai_proxy_tpu/replay/player.py``).

``TracePlayer`` iterates a parsed trace as (device, frame, meta) in trace
order -- every frame exactly once, no wall clock in the loop, frames
byte-identical across runs (``trace.decode_frame``) -- for the lockstep
determinism harness (``replay/harness.py``). ``meta_for`` rebuilds the
FrameMeta the original publish carried. The ``replay://`` video source
that plays a trace through an ingest worker comes with the ingest worker
in a later slice.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..bus.interface import FrameMeta
from . import trace as trace_mod


def meta_for(ev: dict, frame: np.ndarray,
             timestamp_ms: Optional[int] = None) -> FrameMeta:
    """Frame event -> the FrameMeta the original publish carried.
    ``timestamp_ms`` None keeps the RECORDED epoch stamp (deterministic
    lockstep replays); pass a fresh stamp for live-pipeline replays where
    latency accounting must use this run's clock."""
    return FrameMeta(
        width=frame.shape[1],
        height=frame.shape[0],
        channels=frame.shape[2] if frame.ndim == 3 else 1,
        timestamp_ms=int(ev["ts_ms"] if timestamp_ms is None
                         else timestamp_ms),
        pts=ev["pts"] if ev["pts"] is not None else 0,
        dts=ev["dts"] if ev["dts"] is not None else 0,
        packet=ev["packet"],
        is_keyframe=ev["key"],
        frame_type="I" if ev["key"] else "P",
        time_base=ev.get("tb", 1.0 / 90000.0),
    )


class TracePlayer:
    """Parsed trace + deterministic frame iteration (no wall clock)."""

    def __init__(self, path: str):
        self.path = path
        self.header, self.events = trace_mod.read_trace(path)
        self.devices = trace_mod.trace_devices(self.events)

    def stream_info(self, device_id: str) -> Optional[dict]:
        for ev in self.events:
            if ev.get("ev") == "stream" and ev.get("device") == device_id:
                return ev
        return None

    def frame_events(self, device_id: Optional[str] = None) -> list[dict]:
        return list(trace_mod.iter_frames(self.events, device_id))

    def iter_frames(
        self, device_id: Optional[str] = None,
    ) -> Iterator[tuple[str, np.ndarray, FrameMeta]]:
        """(device_id, frame, meta) in trace order — every frame exactly
        once, recorded timestamps preserved. The lockstep harness path."""
        for ev in trace_mod.iter_frames(self.events, device_id):
            frame = trace_mod.decode_frame(ev)
            yield ev["device"], frame, meta_for(ev, frame)

"""Trace replay (counterpart of ``video_edge_ai_proxy_tpu/replay/player.py``).

- ``TracePlayer`` iterates a parsed trace as (device, frame, meta) in
  trace order -- every frame exactly once, no wall clock in the loop,
  frames byte-identical across runs (``trace.decode_frame``) -- for the
  lockstep determinism harness (``replay/harness.py``). ``meta_for``
  rebuilds the FrameMeta the original publish carried.
- ``ReplaySource`` is the ``VideoSource`` behind the ``replay://`` URL
  (``ingest/sources.py`` ``open_source``): a stock ingest worker plays a
  recorded stream through the bus instead of a camera, paced on the
  recorded arrival offsets (``pace=1``) or flat out (``pace=0``).

URL: ``replay:///abs/path.vtrace?device=cam0&pace=1&loop=0&start=0``.
``device`` defaults to the trace's only stream (an error if there are
several); ``loop=1`` restarts at the end instead of ending the stream
(without it the worker's reconnect loop re-opens the source and replays
from the start, and ``loop=0`` lets bounded runs end); ``start=N`` skips
the first N frame events and paces from the (N+1)-th arrival.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..bus.interface import FrameMeta
from ..ingest.sources import PacketInfo, VideoSource
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


class ReplaySource(VideoSource):
    """``replay://`` VideoSource: a recorded stream played back through the
    stock ingest worker. grab() paces on the recorded ``t_ms`` arrival
    offsets (1x) or runs flat out (``pace=0``); retrieve() reproduces the
    recorded bytes exactly."""

    kind = "replay"

    def __init__(self, url: str):
        u = urlparse(url)
        q = {k: v[-1] for k, v in parse_qs(u.query).items()}
        # replay://rel/path and replay:///abs/path both resolve: urlparse
        # puts a relative first segment in netloc.
        self.trace_path = (u.netloc + u.path) if u.netloc else u.path
        self.device = q.get("device", "")
        self.pace = q.get("pace", "1") not in ("0", "false")
        self.loop = q.get("loop", "0") in ("1", "true")
        try:
            self.start = max(0, int(q.get("start", "0")))
        except ValueError:
            raise ValueError(f"replay url start={q.get('start')!r} is not an integer")
        self._player: Optional[TracePlayer] = None
        self._events: list = []
        self._i = -1
        self._t0 = 0.0
        self._base_ms = 0.0
        self._cur: Optional[dict] = None

    def open(self) -> None:
        try:
            self._player = TracePlayer(self.trace_path)
        except (OSError, trace_mod.TraceError) as exc:
            raise ConnectionError(f"cannot open trace: {exc}") from exc
        if not self.device:
            if len(self._player.devices) != 1:
                raise ConnectionError(f"trace {self.trace_path} has streams "
                                      f"{self._player.devices}; pass ?device=<id>")
            self.device = self._player.devices[0]
        self._events = self._player.frame_events(self.device)
        if self.start:
            # Resume from a cursor: pacing re-bases on the first remaining
            # event, so the gaps after it match the recording.
            self._events = self._events[self.start:]
        if not self._events:
            raise ConnectionError(
                f"trace {self.trace_path} has no frames for device {self.device!r}"
                + (f" at start={self.start}" if self.start else ""))
        info = self._player.stream_info(self.device) or {}
        first = self._events[0]
        shape = first.get("shape") or [first["synth"]["h"], first["synth"]["w"], 3]
        self.height = int(info.get("h") or shape[0])
        self.width = int(info.get("w") or shape[1])
        self.fps = float(info.get("fps") or 30.0)
        self._i = -1
        self._t0 = time.monotonic()
        self._base_ms = self._events[0]["t_ms"]
        self._cur = None

    def grab(self) -> Optional[PacketInfo]:
        if self._player is None:
            return None
        self._i += 1
        if self._i >= len(self._events):
            if not self.loop:
                return None
            # Loop: re-base the pacing clock so the gaps repeat.
            self._i = 0
            self._t0 = time.monotonic()
        ev = self._events[self._i]
        if self.pace:
            delay = self._t0 + (ev["t_ms"] - self._base_ms) / 1000.0 - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        self._cur = ev
        # Trace events decode on their own (pattern math or zlib), so a
        # start= resume point is a keyframe: the worker's decode gate must
        # not skip the cursor's packet on a freshly started worker.
        key = bool(ev["key"]) or (self._i == 0 and self.start > 0)
        return PacketInfo(packet=ev["packet"], is_keyframe=key, pts=ev["pts"], dts=ev["dts"],
                          timestamp_ms=int(time.time() * 1000),
                          time_base=ev.get("tb", 1.0 / 90000.0))

    def retrieve(self) -> Optional[np.ndarray]:
        if self._cur is None:
            return None
        return trace_mod.decode_frame(self._cur)

    def close(self) -> None:
        self._player = None
        self._events = []
        self._cur = None

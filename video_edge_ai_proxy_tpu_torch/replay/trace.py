"""Versioned, append-only trace file format (counterpart of
``video_edge_ai_proxy_tpu/replay/trace.py``; the two packages read each
other's files).

One trace file = a header line + one JSON line per event, newline-framed:

    {"magic": "VEPTRACE", "version": 1, "created_ms": ...}
    {"ev": "stream", "device": "cam0", "w": 1280, "h": 720, "fps": 30, ...}
    {"ev": "frame", "device": "cam0", "t_ms": 33.4, "pts": 3000, ...}
    ...
    {"ev": "end", "frames": 512}

A crash mid-append leaves a valid prefix (the reader tolerates a missing
``end`` record and one torn final line). Frame pixels travel one of two
ways:

- ``synth``: ``{"w", "h", "n"}`` -- frame ``n`` of the deterministic
  ``SyntheticSource`` pattern, regenerated at replay (~100 bytes an event);
- ``data``: base64(zlib(raw BGR24 bytes)) + ``shape`` -- lossless capture
  of real frames (zlib round-trips exactly).

``t_ms`` is the arrival time relative to the trace's first event;
``ts_ms`` keeps the original epoch publish timestamp.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import zlib
from typing import Iterator, Optional

import numpy as np

from ..ingest.sources import SyntheticSource

TRACE_MAGIC = "VEPTRACE"
TRACE_VERSION = 1


class TraceError(ValueError):
    """Malformed trace: bad magic, unsupported version, corrupt line."""


class TraceWriter:
    """Append-only writer. Thread-safe (the bus tap records from whatever
    thread publishes); every event is written as one line + flush so a
    crash loses at most the in-flight line, never the framing."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w", encoding="utf-8")
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._frames = 0
        self._closed = False
        header = {
            "magic": TRACE_MAGIC,
            "version": TRACE_VERSION,
            "created_ms": int(time.time() * 1000),
        }
        self._fh.write(json.dumps(header, separators=(",", ":")) + "\n")
        self._fh.flush()

    def rel_ms(self) -> float:
        """Milliseconds since the trace opened (the event clock)."""
        return (time.monotonic() - self._t0) * 1000.0

    def append(self, event: dict) -> None:
        with self._lock:
            if self._closed:
                return
            if event.get("ev") == "frame":
                self._frames += 1
            self._fh.write(json.dumps(event, separators=(",", ":")) + "\n")
            self._fh.flush()

    def stream_event(
        self, device_id: str, *, width: int, height: int,
        fps: float = 0.0, gop: int = 0, kind: str = "",
    ) -> None:
        self.append({
            "ev": "stream", "device": device_id, "t_ms": round(self.rel_ms(), 3),
            "w": int(width), "h": int(height), "fps": float(fps),
            "gop": int(gop), "kind": kind,
        })

    def frame_event(
        self, device_id: str, *,
        pts, dts, is_keyframe: bool, packet: int, timestamp_ms: int,
        time_base: float = 1.0 / 90000.0,
        synth: Optional[dict] = None,
        frame: Optional[np.ndarray] = None,
    ) -> None:
        """One published frame. Exactly one of ``synth`` (pattern seed
        ``{"w","h","n"}``) or ``frame`` (raw pixels, zlib+base64) carries
        the pixel content."""
        ev = {
            "ev": "frame", "device": device_id,
            "t_ms": round(self.rel_ms(), 3),
            "pts": pts, "dts": dts, "key": bool(is_keyframe),
            "packet": int(packet), "ts_ms": int(timestamp_ms),
            "tb": time_base,
        }
        if synth is not None:
            ev["synth"] = {"w": int(synth["w"]), "h": int(synth["h"]),
                           "n": int(synth["n"])}
        elif frame is not None:
            arr = np.ascontiguousarray(frame)
            ev["shape"] = list(arr.shape)
            ev["dtype"] = str(arr.dtype)
            ev["data"] = base64.b64encode(
                zlib.compress(arr.tobytes(), 1)).decode("ascii")
        else:
            raise ValueError("frame_event needs synth= or frame=")
        self.append(ev)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._fh.write(json.dumps(
                {"ev": "end", "frames": self._frames},
                separators=(",", ":")) + "\n")
            self._fh.close()


def decode_frame(event: dict) -> np.ndarray:
    """Frame event -> HxWx3 uint8 BGR24 array, byte-identical to what was
    recorded. Synthetic events regenerate through the SAME pattern math
    the live SyntheticSource uses (single source of truth)."""
    synth = event.get("synth")
    if synth is not None:
        return SyntheticSource.render(synth["h"], synth["w"], synth["n"])
    raw = zlib.decompress(base64.b64decode(event["data"]))
    return np.frombuffer(raw, dtype=event.get("dtype", "uint8")).reshape(
        event["shape"]).copy()


def read_trace(path: str) -> tuple[dict, list[dict]]:
    """Parse a trace -> (header, events). Raises TraceError on bad magic /
    unsupported version; tolerates a missing ``end`` record and one torn
    final line (crash mid-append leaves a valid prefix by design)."""
    with open(path, "r", encoding="utf-8") as fh:
        first = fh.readline()
        try:
            header = json.loads(first)
        except ValueError as exc:
            raise TraceError(f"unreadable trace header in {path}") from exc
        if not isinstance(header, dict) or header.get("magic") != TRACE_MAGIC:
            raise TraceError(f"{path} is not a {TRACE_MAGIC} trace")
        if header.get("version") != TRACE_VERSION:
            raise TraceError(
                f"trace version {header.get('version')} unsupported "
                f"(reader speaks {TRACE_VERSION})")
        events: list[dict] = []
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                break  # torn final line: keep the valid prefix
            if isinstance(ev, dict):
                events.append(ev)
    return header, events


def iter_frames(
    events: list[dict], device_id: Optional[str] = None,
) -> Iterator[dict]:
    """Frame events, optionally restricted to one device, in trace order."""
    for ev in events:
        if ev.get("ev") != "frame":
            continue
        if device_id is not None and ev.get("device") != device_id:
            continue
        yield ev


def trace_devices(events: list[dict]) -> list[str]:
    """Device ids appearing in the trace, first-seen order."""
    seen: list[str] = []
    for ev in events:
        d = ev.get("device")
        if d and d not in seen:
            seen.append(d)
    return seen

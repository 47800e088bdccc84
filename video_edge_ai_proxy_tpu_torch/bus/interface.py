"""Frame-bus interface: the subset the serving engine reads.

Counterpart of ``video_edge_ai_proxy_tpu/bus/interface.py``. Frame plane
semantics are the same: a latest-wins ring per camera, per-reader cursors
(sequence numbers), frames as HWC uint8 BGR24. The fast path reads a frame
straight into a slot of a pooled batch (``read_latest_into``), probes a
ring's newest sequence number cheaply (``head``) and blocks on the publish
doorbell between ticks (``doorbell_token`` / ``doorbell_wait``). The
control-plane key-value store is not ported.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..obs import registry as obs_registry


def note_publish(backend: str, device_id: str, nbytes: int) -> None:
    """Publish accounting shared by every bus backend: frames and payload
    bytes per (backend, stream)."""
    obs_registry.counter(
        "vep_bus_published_total", "Frames published to the bus",
        ("backend", "stream"),
    ).labels(backend, device_id).inc()
    obs_registry.counter(
        "vep_bus_published_bytes_total", "Frame payload bytes published",
        ("backend", "stream"),
    ).labels(backend, device_id).inc(float(nbytes))


@dataclass
class FrameMeta:
    """Per-frame metadata (the VideoFrame message's fields)."""

    width: int = 0
    height: int = 0
    channels: int = 3
    timestamp_ms: int = 0
    pts: int = 0
    dts: int = 0
    packet: int = 0
    keyframe_cnt: int = 0
    is_keyframe: bool = False
    is_corrupt: bool = False
    frame_type: str = ""
    time_base: float = 0.0
    trace_id: int = 0
    parent_span: int = 0


@dataclass
class Frame:
    seq: int
    data: np.ndarray  # HWC uint8 BGR24
    meta: FrameMeta = field(default_factory=FrameMeta)


class FrameBus(ABC):
    """Abstract frame bus: per-stream latest-wins rings."""

    @abstractmethod
    def create_stream(self, device_id: str, frame_bytes: int, slots: int = 4) -> None:
        """Producer-side: (re)create the ring for a camera."""

    @abstractmethod
    def publish(self, device_id: str, data: np.ndarray, meta: FrameMeta) -> int:
        """Publish one frame; returns its sequence number."""

    @abstractmethod
    def read_latest(self, device_id: str, min_seq: int = 0) -> Optional[Frame]:
        """Newest frame with seq > min_seq, or None. Non-blocking."""

    def read_latest_into(self, device_id: str, dst: np.ndarray, min_seq: int = 0):
        """Newest frame with seq > min_seq copied INTO ``dst`` (a C-contiguous
        uint8 [H, W, C] view, e.g. one slot of a pooled batch). Returns None
        when there is no new frame; (seq, FrameMeta) after copying into
        ``dst``; or the whole Frame when its geometry does not match ``dst``
        (the caller re-groups with it, nothing is lost).

        The default wraps ``read_latest`` (two memory passes); a backend
        that can copy from its ring straight into ``dst`` overrides it."""
        frame = self.read_latest(device_id, min_seq=min_seq)
        if frame is None:
            return None
        if frame.data.shape != dst.shape or frame.data.dtype != dst.dtype:
            return frame
        np.copyto(dst, frame.data)
        return frame.seq, frame.meta

    @abstractmethod
    def streams(self) -> list:
        """Device ids with a live ring."""

    def head(self, device_id: str) -> Optional[int]:
        """Latest published seq for the stream, or None when unknown. Must
        be cheap (no frame copy): the assembly sweep probes it per planned
        stream per doorbell wake to skip idle rings."""
        return None

    # True when the backend has a cheap publish wake-up: a consumer can
    # block on doorbell_wait instead of sleeping to the tick boundary.
    doorbell = False

    def doorbell_token(self) -> int:
        """Current doorbell value; pass it to doorbell_wait."""
        return 0

    def doorbell_wait(self, token: int, timeout_s: float) -> int:
        """Block until any stream publishes (the doorbell moved past
        ``token``) or ``timeout_s`` elapses; returns the current token.
        Default: a plain sleep, for backends without a doorbell."""
        time.sleep(timeout_s)
        return self.doorbell_token()

    def drop_stream(self, device_id: str) -> None:
        """Producer side: remove the ring (camera stopped)."""

    def close(self) -> None:
        pass

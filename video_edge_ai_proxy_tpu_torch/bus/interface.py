"""Frame-bus interface: the subset the serving engine reads.

Counterpart of ``video_edge_ai_proxy_tpu/bus/interface.py``. Frame plane
semantics are the same: a latest-wins ring per camera, per-reader cursors
(sequence numbers), frames as HWC uint8 BGR24.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


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

    @abstractmethod
    def streams(self) -> list:
        """Device ids with a live ring."""

    def head(self, device_id: str) -> Optional[int]:
        """Latest published seq for the stream, or None when unknown."""
        return None

    def close(self) -> None:
        pass

"""In-process frame bus (counterpart of ``video_edge_ai_proxy_tpu/bus/memory_bus.py``).

Latest-wins ring per stream with plain Python data structures, for tests
and single-process deployments.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np

from .interface import Frame, FrameBus, FrameMeta


class MemoryFrameBus(FrameBus):
    def __init__(self):
        self._lock = threading.Lock()
        self._rings: dict = {}
        self._seq: dict = {}

    def create_stream(self, device_id: str, frame_bytes: int, slots: int = 4) -> None:
        with self._lock:
            self._rings[device_id] = deque(maxlen=max(1, slots))
            self._seq[device_id] = 0

    def publish(self, device_id: str, data: np.ndarray, meta: FrameMeta) -> int:
        with self._lock:
            if device_id not in self._rings:
                raise ValueError(f"stream {device_id!r} not created")
            self._seq[device_id] += 1
            seq = self._seq[device_id]
            self._rings[device_id].append(
                Frame(seq=seq, data=np.array(data, copy=True), meta=meta)
            )
        return seq

    def head(self, device_id: str) -> Optional[int]:
        with self._lock:
            return self._seq.get(device_id)

    def read_latest(self, device_id: str, min_seq: int = 0) -> Optional[Frame]:
        with self._lock:
            ring = self._rings.get(device_id)
            if not ring:
                return None
            frame = ring[-1]
            if frame.seq <= min_seq:
                return None
            # Copy out: consumers may write into the pixels.
            return Frame(seq=frame.seq, data=frame.data.copy(), meta=frame.meta)

    def streams(self) -> list:
        with self._lock:
            return sorted(self._rings)

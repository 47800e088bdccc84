"""In-process frame bus (counterpart of ``video_edge_ai_proxy_tpu/bus/memory_bus.py``).

Latest-wins ring per stream and the string KV with plain Python data
structures, for tests and single-process deployments, with the publish
doorbell (a condition variable) that wakes the collector's assembly sweep.
The same semantics as ``ShmFrameBus``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import numpy as np

from .interface import Frame, FrameBus, FrameMeta, note_publish


class MemoryFrameBus(FrameBus):
    doorbell = True

    def __init__(self):
        self._lock = threading.Lock()
        self._rings: dict = {}
        self._seq: dict = {}
        self._kv: dict = {}
        self._db = threading.Condition()
        self._db_value = 0

    def create_stream(self, device_id: str, frame_bytes: int, slots: int = 4) -> None:
        with self._lock:
            self._rings[device_id] = deque(maxlen=max(1, slots))
            self._seq[device_id] = 0

    def publish(self, device_id: str, data: np.ndarray, meta: FrameMeta) -> int:
        # The producer's copy is taken outside the lock: a ring slot is
        # never written after it is appended, so readers copy from it
        # without holding the lock either.
        data = np.array(data, copy=True)
        with self._lock:
            if device_id not in self._rings:
                raise ValueError(f"stream {device_id!r} not created")
            self._seq[device_id] += 1
            seq = self._seq[device_id]
            self._rings[device_id].append(Frame(seq=seq, data=data, meta=meta))
        with self._db:
            self._db_value += 1
            self._db.notify_all()
        note_publish("memory", device_id, data.nbytes)
        return seq

    def doorbell_token(self) -> int:
        with self._db:
            return self._db_value

    def doorbell_wait(self, token: int, timeout_s: float) -> int:
        with self._db:
            if self._db_value == token:
                self._db.wait(timeout_s)
            return self._db_value

    def head(self, device_id: str) -> Optional[int]:
        with self._lock:
            return self._seq.get(device_id)

    def _newest(self, device_id: str, min_seq: int) -> Optional[Frame]:
        with self._lock:
            ring = self._rings.get(device_id)
            if not ring or ring[-1].seq <= min_seq:
                return None
            return ring[-1]

    def read_latest(self, device_id: str, min_seq: int = 0) -> Optional[Frame]:
        frame = self._newest(device_id, min_seq)
        if frame is None:
            return None
        # Copy out: consumers may write into the pixels.
        return Frame(seq=frame.seq, data=frame.data.copy(), meta=frame.meta)

    def read_latest_into(self, device_id: str, dst: np.ndarray, min_seq: int = 0):
        """One memory pass: ring slot -> ``dst``."""
        frame = self._newest(device_id, min_seq)
        if frame is None:
            return None
        if frame.data.shape != dst.shape or frame.data.dtype != dst.dtype:
            return Frame(seq=frame.seq, data=frame.data.copy(), meta=frame.meta)
        np.copyto(dst, frame.data)
        return frame.seq, frame.meta

    def streams(self) -> list:
        with self._lock:
            return sorted(self._rings)

    def drop_stream(self, device_id: str) -> None:
        with self._lock:
            self._rings.pop(device_id, None)
            self._seq.pop(device_id, None)

    def kv_set(self, key: str, value: str) -> None:
        with self._lock:
            self._kv[key] = value

    def kv_get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)

    def kv_keys(self) -> list:
        with self._lock:
            return sorted(self._kv)

    def close(self) -> None:
        # Wake doorbell waiters so nothing sleeps out a timeout against a
        # closed bus.
        with self._db:
            self._db_value += 1
            self._db.notify_all()

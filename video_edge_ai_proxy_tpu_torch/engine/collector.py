"""Batch collector: N camera streams -> padded batches per tick.

Counterpart of the core of ``video_edge_ai_proxy_tpu/engine/collector.py``:
each tick takes the newest unseen frame per stream (latest-wins), groups
the frames by source geometry, and pads each group to the smallest
covering batch bucket, so the serving step sees a small closed set of
shapes. Video models get clip assembly: a per-stream sliding window of the
last ``clip_len`` frames, sampled as one [clip_len, H, W, 3] clip once it
is full. The window grows by at most one frame per stream per tick, so a
producer that publishes faster than the collector ticks skips frames.
Leases, the staging pool, ROI canvases and shards are not part of this
slice.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..bus.interface import FrameBus, FrameMeta


@dataclass
class BatchGroup:
    """One shape-homogeneous batch."""

    src_hw: tuple            # (H, W) of the source frames
    device_ids: List[str]
    frames: np.ndarray       # [N, H, W, C] uint8, or [N, T, H, W, C] for clips
    metas: List[FrameMeta]
    bucket: int = 0          # padded batch size chosen by pad_to_bucket

    @property
    def padded_slots(self) -> int:
        return max(0, self.bucket - len(self.device_ids))


def pad_to_bucket(group: BatchGroup, buckets: Sequence[int]) -> BatchGroup:
    """Zero-pad the batch dim to the smallest bucket >= N. Oversized
    batches are the caller's job (Collector.collect chunks to max bucket)."""
    n = group.frames.shape[0]
    bucket = next((b for b in sorted(buckets) if b >= n), None)
    if bucket is None:
        raise ValueError(f"batch {n} exceeds max bucket {max(buckets)}")
    if bucket != n:
        pad = np.zeros((bucket - n,) + group.frames.shape[1:], group.frames.dtype)
        group.frames = np.concatenate([group.frames, pad], axis=0)
    group.bucket = bucket
    return group


class Collector:
    """Per-stream cursors, clip windows and per-tick batch assembly.
    ``clip_len`` > 0 (a video model) makes every sample a clip."""

    def __init__(self, bus: FrameBus, *, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 clip_len: int = 0):
        self._bus = bus
        self._buckets = tuple(sorted(buckets))
        self._cursors: Dict[str, int] = {}
        self.clip_len = clip_len
        self._clips: Dict[str, deque] = {}

    def _clip(self, device_id: str, frame) -> "np.ndarray | None":
        """Append ``frame`` to the stream's window; the [clip_len, H, W, C]
        clip once the window is full, else None."""
        window = self._clips.get(device_id)
        if window is None or window.maxlen != self.clip_len:
            # (Re)create on a clip-length change: no stale window carries over.
            window = deque(maxlen=self.clip_len)
            self._clips[device_id] = window
        if window and window[-1].data.shape != frame.data.shape:
            window.clear()      # a geometry change starts a new clip
        window.append(frame)
        if len(window) < self.clip_len:
            return None
        return np.stack([f.data for f in window])

    def collect(self) -> List[BatchGroup]:
        """One tick: newest unseen frame per stream -> geometry-grouped,
        bucket-padded batches of frames, or of clips for a video model (a
        group larger than the biggest bucket is split into chunks of that
        size)."""
        by_hw: Dict[tuple, list] = {}
        for device_id in self._bus.streams():
            frame = self._bus.read_latest(device_id, min_seq=self._cursors.get(device_id, 0))
            if frame is None:
                continue
            self._cursors[device_id] = frame.seq
            if frame.data.ndim != 3:
                continue    # a corrupt frame carries no geometry to batch on
            sample = self._clip(device_id, frame) if self.clip_len else frame.data
            if sample is not None:
                by_hw.setdefault(frame.data.shape, []).append((device_id, frame.meta, sample))
        max_bucket = self._buckets[-1]
        groups: List[BatchGroup] = []
        for shape, items in sorted(by_hw.items()):
            for start in range(0, len(items), max_bucket):
                chunk = items[start:start + max_bucket]
                groups.append(pad_to_bucket(BatchGroup(
                    src_hw=shape[:2],
                    device_ids=[d for d, _, _ in chunk],
                    frames=np.stack([x for _, _, x in chunk]),
                    metas=[m for _, m, _ in chunk],
                ), self._buckets))
        return groups

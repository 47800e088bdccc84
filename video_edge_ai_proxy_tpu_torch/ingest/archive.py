"""GOP segment archiver (counterpart of ``video_edge_ai_proxy_tpu/ingest/archive.py``,
its decoded-frame path).

A thread consumes segments from a bounded queue and writes one file per
segment under ``<out_dir>/<device_id>/`` named ``<start_ts_ms>_<duration_ms>``
(the reference's naming contract; a segment that starts in the same
millisecond as another gets a ``-n`` suffix). ``GopSegment`` carries decoded
frames: they are encoded through OpenCV's ``VideoWriter`` (mp4v) when
``cv2`` imports and can open the file, else saved raw as ``.npz``, as the
JAX package chooses. The engine's cascade writes its enter events' clips
through it.

``PacketGopSegment`` (the stream-copy mux of compressed GOPs) needs PyAV,
which the port does not carry: it raises.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

log = logging.getLogger("vep.torch.ingest.archive")

POLL_S = 1.0


@dataclass
class GopSegment:
    device_id: str
    start_ts_ms: int
    end_ts_ms: int
    fps: float
    frames: List[np.ndarray] = field(default_factory=list)

    @property
    def duration_ms(self) -> int:
        """The timestamp span; frame count over fps when the span is empty."""
        span = self.end_ts_ms - self.start_ts_ms
        if span > 0:
            return span
        return int(len(self.frames) * 1000 / max(self.fps, 1.0))


class PacketGopSegment:
    """A compressed GOP for the stream-copy mux: not ported (it needs
    PyAV)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("PacketGopSegment (the stream-copy mux of compressed GOPs) "
                                  "needs PyAV and is not ported; archive decoded frames with "
                                  "GopSegment")


class SegmentArchiver:
    """Background thread writing segments to ``<out_dir>/<device_id>/``."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._q: "queue.Queue[GopSegment]" = queue.Queue(maxsize=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.written = 0

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        self._thread = threading.Thread(target=self._run, name="vep-torch-archiver",
                                        daemon=True)
        self._thread.start()

    def submit(self, seg: GopSegment) -> None:
        try:
            self._q.put_nowait(seg)
        except queue.Full:
            log.warning("archive queue full; dropping a segment of %s", seg.device_id)

    def _run(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                seg = self._q.get(timeout=POLL_S)
            except queue.Empty:
                continue
            try:
                self._write(seg)
                self.written += 1
            except Exception:   # the archiver must not end on one bad segment
                log.exception("failed to archive a segment of %s", seg.device_id)

    def _write(self, seg: GopSegment) -> None:
        if not seg.frames:
            return
        dev_dir = os.path.join(self.out_dir, seg.device_id)
        os.makedirs(dev_dir, exist_ok=True)
        stem = f"{seg.start_ts_ms}_{seg.duration_ms}"
        n = 1
        while (os.path.exists(os.path.join(dev_dir, stem + ".mp4"))
               or os.path.exists(os.path.join(dev_dir, stem + ".npz"))):
            stem = f"{seg.start_ts_ms}_{seg.duration_ms}-{n}"
            n += 1
        if not self._write_mp4(os.path.join(dev_dir, stem + ".mp4"), seg):
            np.savez_compressed(os.path.join(dev_dir, stem + ".npz"),
                                frames=np.stack(seg.frames), fps=seg.fps,
                                start_ts_ms=seg.start_ts_ms)

    @staticmethod
    def _write_mp4(path: str, seg: GopSegment) -> bool:
        try:
            import cv2
        except ImportError:
            return False
        h, w = seg.frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), max(seg.fps, 1.0),
                                 (w, h))
        if not writer.isOpened():
            return False
        try:
            for f in seg.frames:
                writer.write(f)
        finally:
            writer.release()
        return os.path.getsize(path) > 0

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

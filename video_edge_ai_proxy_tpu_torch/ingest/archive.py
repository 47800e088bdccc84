"""GOP segment archiver (counterpart of ``video_edge_ai_proxy_tpu/ingest/archive.py``).

A thread consumes segments from a bounded queue and writes one file per
segment under ``<out_dir>/<device_id>/`` named ``<start_ts_ms>_<duration_ms>``
(the reference's naming contract; a segment that starts in the same
millisecond as another gets a ``-n`` suffix). Two payloads:

- ``PacketGopSegment`` (packet sources): the compressed GOP, audio
  interleaved when the camera has a mic, is stream-copied into the MP4
  through the libav shim with pts/dts rebased to 0 from one epoch for
  both streams: bit-exact, no codec work.
- ``GopSegment`` (decoded frames; the OpenCV fallback and the engine's
  cascade clips): encoded through OpenCV's ``VideoWriter`` (mp4v) when
  ``cv2`` imports and can open the file, else saved raw as ``.npz``.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils.logging import get_logger

log = get_logger("ingest.archive")

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


@dataclass
class PacketGopSegment:
    """One compressed GOP: ``av.Packet``s (payloads included, audio
    interleaved when the camera has a mic) and the demuxer's
    ``StreamInfo``s for the stream-copy mux."""

    device_id: str
    start_ts_ms: int
    info: object                       # av.StreamInfo (video)
    packets: List[object] = field(default_factory=list)  # av.Packet
    audio_info: object = None          # av.StreamInfo (audio) or None

    @property
    def duration_ms(self) -> int:
        """The video packets' durations summed; the dts span when a camera
        ships no durations. Audio packets are left out: a segment's
        duration is a property of its video."""
        num, den = self.info.time_base
        scale = 1000.0 * num / den
        video = [p for p in self.packets if not getattr(p, "is_audio", False)]
        total = sum(max(p.duration, 0) for p in video)
        if total > 0:
            return int(total * scale)
        # The span over packets with a real dts (None is AV_NOPTS).
        valid = [p.dts for p in video if p.dts is not None]
        if len(valid) >= 2:
            span = valid[-1] - valid[0]
            # The span misses the last frame's display time; pro-rate it.
            span += span // max(len(valid) - 1, 1)
            return int(span * scale)
        return 0


class SegmentArchiver:
    """Background thread writing segments to ``<out_dir>/<device_id>/``."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._q: "queue.Queue" = queue.Queue(maxsize=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.written = 0

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        self._thread = threading.Thread(target=self._run, name="vep-torch-archiver",
                                        daemon=True)
        self._thread.start()

    def submit(self, seg) -> None:
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

    def _write(self, seg) -> None:
        packets = isinstance(seg, PacketGopSegment)
        if not (seg.packets if packets else seg.frames):
            return
        dev_dir = os.path.join(self.out_dir, seg.device_id)
        os.makedirs(dev_dir, exist_ok=True)
        stem = f"{seg.start_ts_ms}_{seg.duration_ms}"
        n = 1
        while (os.path.exists(os.path.join(dev_dir, stem + ".mp4"))
               or os.path.exists(os.path.join(dev_dir, stem + ".npz"))):
            stem = f"{seg.start_ts_ms}_{seg.duration_ms}-{n}"
            n += 1
        path = os.path.join(dev_dir, stem + ".mp4")
        if packets:
            self._write_stream_copy(path, seg)
            return
        if not self._write_mp4(path, seg):
            np.savez_compressed(os.path.join(dev_dir, stem + ".npz"),
                                frames=np.stack(seg.frames), fps=seg.fps,
                                start_ts_ms=seg.start_ts_ms)

    @staticmethod
    def _write_stream_copy(path: str, seg: PacketGopSegment) -> None:
        """Mux the compressed GOP with pts/dts rebased so the segment starts
        at 0, from one epoch for both streams: each subtracts the same
        instant (the earlier of the two stream heads), in its own time
        base, so a camera whose audio starts late keeps its offset. No
        transcode."""
        from fractions import Fraction

        from .av import StreamCopyMuxer

        def first_ts(pkts):
            # A stream head may carry no dts (AV_NOPTS -> None): rebase from
            # the first packet with any timestamp (dts, else pts); where no
            # packet has one, write unrebased and let libav derive.
            return next((p.dts if p.dts is not None else p.pts for p in pkts
                         if p.dts is not None or p.pts is not None), 0)

        def is_audio(p):
            return getattr(p, "is_audio", False)

        base = first_ts([p for p in seg.packets if not is_audio(p)])
        abase = first_ts([p for p in seg.packets if is_audio(p)])
        have_audio = seg.audio_info is not None and any(is_audio(p) for p in seg.packets)
        if have_audio:
            vnum, vden = seg.info.time_base
            anum, aden = seg.audio_info.time_base
            if vnum > 0 and vden > 0 and anum > 0 and aden > 0:
                # Exact rational clock arithmetic: the earlier stream head
                # is the shared epoch, expressed in each time base (floor,
                # so the head that defines it never rebases to -1).
                vtb = Fraction(vnum, vden)
                atb = Fraction(anum, aden)
                epoch = min(base * vtb, abase * atb)   # seconds
                base = int(epoch // vtb)
                abase = int(epoch // atb)
        mux = StreamCopyMuxer(path, seg.info, audio_info=seg.audio_info)
        with mux:
            for pkt in seg.packets:
                mux.write(pkt, ts_offset=abase if is_audio(pkt) else base)

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

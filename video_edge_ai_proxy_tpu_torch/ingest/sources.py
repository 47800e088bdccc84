"""Video sources (counterpart of ``video_edge_ai_proxy_tpu/ingest/sources.py``):
the two-phase source contract and its four sources.

``grab()`` advances the stream without decoding pixels (cheap),
``retrieve()`` produces the BGR24 frame. ``SyntheticSource`` is the
deterministic moving test pattern; its ``render(h, w, n)`` is the single
source of truth the replay plane regenerates ``synth`` trace events from.
``PacketSource`` reads cameras and files through the port's libav shim
(``ingest/av.py``): ``grab()`` is a pure demux with the demuxer's own
keyframe flags, pts, dts and time base, the compressed payload stays
available for the stream-copy archive and pass-through, and ``retrieve()``
decodes the grabbed packet. ``OpenCVSource`` is the fallback where the
shim cannot build (its ``grab()`` runs the codec, and its keyframes are a
GOP-cadence guess).

``open_source`` routes a URL: ``test://`` to ``SyntheticSource``,
``replay://`` to the recorded-trace source (``replay/player.py``
``ReplaySource``), anything else (``rtsp://``, a file) to
``PacketSource``, or to ``OpenCVSource`` when the shim is unavailable or
``vep_source=opencv`` asks for it. None of these imports torch.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


@dataclass
class PacketInfo:
    """Demux-level info available before any pixel decode."""

    packet: int          # 0-based packet counter
    is_keyframe: bool
    pts: Optional[int]   # None = the source supplied no timestamp
    dts: Optional[int]
    timestamp_ms: int    # wall clock at demux
    time_base: float
    is_corrupt: bool = False
    is_audio: bool = False


class VideoSource(ABC):
    """Two-phase source: grab (demux) then optionally retrieve (decode)."""

    width: int = 0
    height: int = 0
    fps: float = 0.0
    supports_packets: bool = False
    kind: str = ""

    @abstractmethod
    def open(self) -> None:
        """Connect; raises ConnectionError on failure."""

    @abstractmethod
    def grab(self) -> Optional[PacketInfo]:
        """Advance to the next packet without decoding pixels; None = end
        of stream."""

    @abstractmethod
    def retrieve(self) -> Optional[np.ndarray]:
        """Decode the grabbed packet to an HxWx3 uint8 BGR24 array."""

    @abstractmethod
    def close(self) -> None: ...


class SyntheticSource(VideoSource):
    """Deterministic moving test pattern.

    URL: ``test://pattern?w=1280&h=720&fps=30&gop=30&frames=0[&pace=1]``;
    ``frames=0`` = endless, ``pace=0`` runs flat out.
    """

    kind = "synthetic"

    def __init__(self, url: str):
        q = {k: v[-1] for k, v in parse_qs(urlparse(url).query).items()}
        self.width = int(q.get("w", 1280))
        self.height = int(q.get("h", 720))
        self.fps = float(q.get("fps", 30))
        self.gop = int(q.get("gop", 30))
        self.limit = int(q.get("frames", 0))
        self.pace = q.get("pace", "1") not in ("0", "false")
        self._n = -1
        self._t0 = 0.0
        self._open = False
        # Pre-rendered planes; per-frame work happens in retrieve().
        yy, xx = np.mgrid[0:self.height, 0:self.width]
        self._bg = ((xx * 255 // max(1, self.width - 1)) & 0xFF).astype(np.uint8)
        self._yy = yy

    def open(self) -> None:
        self._t0 = time.monotonic()
        self._open = True

    def grab(self) -> Optional[PacketInfo]:
        if not self._open:
            return None
        self._n += 1
        if self.limit and self._n >= self.limit:
            return None
        if self.pace:
            delay = self._t0 + self._n / self.fps - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        pts = int(self._n * 90000 / self.fps)  # 90 kHz clock, as RTP video
        return PacketInfo(packet=self._n, is_keyframe=(self._n % self.gop == 0), pts=pts,
                          dts=pts, timestamp_ms=int(time.time() * 1000),
                          time_base=1.0 / 90000.0)

    @staticmethod
    def render(height: int, width: int, n: int, bg: Optional[np.ndarray] = None,
               yy: Optional[np.ndarray] = None) -> np.ndarray:
        """Frame ``n`` of the pattern as a pure function of (h, w, n):
        gradient, moving bands, a per-frame red level and a moving white
        square. ``bg``/``yy`` are optional precomputed planes."""
        if bg is None or yy is None:
            yy, xx = np.mgrid[0:height, 0:width]
            bg = ((xx * 255 // max(1, width - 1)) & 0xFF).astype(np.uint8)
        frame = np.empty((height, width, 3), dtype=np.uint8)
        frame[:, :, 0] = bg
        frame[:, :, 1] = ((yy + 2 * n) & 0xFF).astype(np.uint8)
        frame[:, :, 2] = (n * 3) & 0xFF
        size = max(8, height // 8)
        x = (n * 7) % max(1, width - size)
        y = (n * 5) % max(1, height - size)
        frame[y:y + size, x:x + size] = (255, 255, 255)
        return frame

    def retrieve(self) -> Optional[np.ndarray]:
        return self.render(self.height, self.width, self._n, bg=self._bg, yy=self._yy)

    def close(self) -> None:
        self._open = False


class OpenCVSource(VideoSource):
    """RTSP, file or HTTP source through OpenCV's ``VideoCapture``: grab() and
    retrieve() map onto ``VideoCapture.grab()`` and ``.retrieve()``;
    keyframes are put on a GOP cadence because ``VideoCapture`` does not
    expose the picture type."""

    kind = "opencv"

    def __init__(self, url: str, gop_hint: int = 30):
        self.url = url
        self.gop = gop_hint
        self._cap = None
        self._n = -1

    def open(self) -> None:
        import cv2

        cap = cv2.VideoCapture(self.url)
        if not cap.isOpened():
            raise ConnectionError(f"failed to open video source {self.url!r}")
        self._cap = cap
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or 0
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or 0
        self.fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def grab(self) -> Optional[PacketInfo]:
        if self._cap is None or not self._cap.grab():
            return None
        self._n += 1
        pts = int(self._n * 90000 / (self.fps or 30.0))
        return PacketInfo(packet=self._n, is_keyframe=(self._n % self.gop == 0), pts=pts,
                          dts=pts, timestamp_ms=int(time.time() * 1000),
                          time_base=1.0 / 90000.0)

    def retrieve(self) -> Optional[np.ndarray]:
        if self._cap is None:
            return None
        ok, frame = self._cap.retrieve()
        if not ok:
            return None
        if self.width == 0 and frame is not None:
            self.height, self.width = frame.shape[:2]
        return frame  # OpenCV yields BGR24

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class PacketSource(VideoSource):
    """Packet-level source over the libav shim (``ingest/av.py``): ``grab()``
    is a pure demux (no codec work, so the lazy-decode gate saves decode
    CPU), keyframe flags, pts, dts and time base come from the demuxer, and
    the compressed payload of the current packet is there for the
    stream-copy archive and RTMP relay. Audio packets (a camera's mic) are
    grabbed as ``PacketInfo(is_audio=True)`` for those consumers only."""

    supports_packets = True
    kind = "packet"

    def __init__(self, url: str, timeout_s: float = 5.0, av_options: str = ""):
        self.url = url
        self.timeout_s = timeout_s
        self.av_options = av_options   # e.g. "rtsp_flags=listen" (push mode)
        self._d = None
        self._n = -1
        self._pkt = None

    def open(self) -> None:
        from . import av

        self._d = av.PacketDemuxer(self.url, timeout_s=self.timeout_s, options=self.av_options)
        info = self._d.info
        self.width, self.height = info.width, info.height
        self.fps = info.fps or 30.0

    @property
    def stream_info(self):
        """``av.StreamInfo`` of the open demuxer (muxer construction)."""
        return self._d.info if self._d is not None else None

    @property
    def audio_info(self):
        """``av.StreamInfo`` of the camera's audio stream, or None: the
        archive's and the relay's audio track."""
        return self._d.audio_info if self._d is not None else None

    def grab(self) -> Optional[PacketInfo]:
        if self._d is None:
            return None
        try:
            pkt = self._d.read()
        except IOError:
            return None  # the worker takes it as the end: reconnect loop
        if pkt is None:
            return None
        self._pkt = pkt
        if pkt.is_audio:
            ainfo = self._d.audio_info
            num, den = ainfo.time_base if ainfo else (1, 48000)
            return PacketInfo(packet=self._n, is_keyframe=False,   # AAC KEY flags are no GOP heads
                              pts=pkt.pts, dts=pkt.dts, timestamp_ms=int(time.time() * 1000),
                              time_base=num / den, is_corrupt=pkt.is_corrupt, is_audio=True)
        self._n += 1
        num, den = self._d.info.time_base
        return PacketInfo(packet=self._n, is_keyframe=pkt.is_keyframe, pts=pkt.pts,
                          dts=pkt.dts, timestamp_ms=int(time.time() * 1000),
                          time_base=num / den, is_corrupt=pkt.is_corrupt)

    def packet_bytes(self) -> bytes:
        """Compressed payload of the grabbed packet (a demux-side copy, no
        codec work)."""
        return self._d.packet_data() if self._d is not None else b""

    def packet_with_data(self):
        """``av.Packet`` of the grabbed packet with its compressed payload
        (GOP buffering, stream-copy consumers)."""
        import dataclasses

        if self._pkt is None:
            return None
        return dataclasses.replace(self._pkt, data=self.packet_bytes())

    def retrieve(self) -> Optional[np.ndarray]:
        if self._d is None:
            return None
        try:
            return self._d.decode()
        except IOError:
            return None

    @property
    def last_frame_type(self) -> str:
        """Picture type ('I'/'P'/'B') of the last decoded frame."""
        return self._d.last_frame_type if self._d is not None else ""

    @property
    def last_frame_pts(self) -> Optional[int]:
        """pts of the last DECODED frame (stream time base): under decoder
        delay it lags the grabbed packet's, and a published frame carries
        its own presentation time."""
        return self._d.last_frame_pts if self._d is not None else None

    def close(self) -> None:
        if self._d is not None:
            self._d.close()
            self._d = None


def open_source(url: str, prefer: str = "") -> VideoSource:
    """Route a URL to a source. ``prefer`` (or the environment's
    ``vep_source``) forces ``opencv`` or ``packet``; otherwise a camera or
    file opens through the libav shim, or through OpenCV when the shim is
    unavailable on this host. Each open counts in
    ``vep_source_opens_total{kind}``."""
    import os

    from ..obs import registry as obs_registry

    opens = obs_registry.counter(
        "vep_source_opens_total", "Video sources opened, by backend kind", ("kind",))
    scheme = urlparse(url).scheme
    if scheme == "test":
        opens.labels("synthetic").inc()
        return SyntheticSource(url)
    if scheme == "replay":
        # replay://<trace-path>?device=<id>&pace=1|0; imported here: a
        # live camera's worker never loads the replay plane.
        from ..replay.player import ReplaySource

        opens.labels("replay").inc()
        return ReplaySource(url)
    prefer = prefer or os.environ.get("vep_source", "")
    if prefer == "opencv":
        opens.labels("opencv").inc()
        return OpenCVSource(url)
    if prefer != "packet":
        from . import av

        if not av.available():
            opens.labels("opencv").inc()
            return OpenCVSource(url)
    # The environment's ``vep_av_options``: extra "k=v:k=v" AVOptions for
    # every packet source a worker opens. "decode_threads=0" turns on
    # libav's frame threads for a camera whose decode needs more than one
    # core; the default is one decode thread a worker.
    opens.labels("packet").inc()
    return PacketSource(url, av_options=os.environ.get("vep_av_options", ""))

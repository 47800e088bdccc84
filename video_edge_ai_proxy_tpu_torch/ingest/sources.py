"""Video sources (counterpart of ``video_edge_ai_proxy_tpu/ingest/sources.py``):
the two-phase source contract and the synthetic pattern source.

``grab()`` advances the stream without decoding pixels (cheap),
``retrieve()`` produces the BGR24 frame. ``SyntheticSource`` is the
deterministic moving test pattern; its ``render(h, w, n)`` is the single
source of truth the replay plane regenerates ``synth`` trace events from.
``open_source`` routes a URL: ``test://`` to ``SyntheticSource`` and
``replay://`` to the recorded-trace source (``replay/player.py``
``ReplaySource``). The sources that open cameras or files (``rtsp://``
and the rest, through libav or OpenCV) are a later slice.
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


def open_source(url: str, prefer: str = "") -> VideoSource:
    """Route a URL to a source: ``test://`` (the synthetic pattern) or
    ``replay://`` (a recorded trace). Camera and file URLs need the libav
    or OpenCV sources, which are not ported yet: they raise. ``prefer``
    (``opencv`` / ``packet``) chooses among those and is not used yet."""
    from ..obs import registry as obs_registry

    opens = obs_registry.counter(
        "vep_source_opens_total", "Video sources opened, by backend kind", ("kind",))
    scheme = urlparse(url).scheme
    if scheme == "test":
        opens.labels("synthetic").inc()
        return SyntheticSource(url)
    if scheme == "replay":
        from ..replay.player import ReplaySource

        opens.labels("replay").inc()
        return ReplaySource(url)
    raise NotImplementedError(
        f"source {url!r} needs the libav "
        "(PyAV) or OpenCV sources, which come in a later slice; the port opens "
        "test:// and replay:// URLs")

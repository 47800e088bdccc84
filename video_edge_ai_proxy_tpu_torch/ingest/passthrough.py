"""RTMP or file pass-through with the buffered-GOP flush (counterpart of
``video_edge_ai_proxy_tpu/ingest/passthrough.py``).

The reference's semantics (``python/rtsp_to_rtmp.py:127-139,163-182``):
the worker demuxes continuously and keeps the current GOP buffered; when
the Proxy toggle turns on (the ``proxy_rtmp`` field of the camera's
``last_access_time_<id>`` hash), it first flushes the buffered GOP, so the
remote stream starts on a decodable keyframe, then relays live. Turning
the toggle off closes the remote mux.

Two transports:

- ``PacketPassthroughWriter`` (packet sources): remuxes the *compressed*
  packets into FLV/RTMP (or a file) through the libav shim: no transcode,
  no pinning of the decode gate, real H.264 on the wire.
- ``PassthroughWriter`` (decoded-frame sources, the OpenCV fallback):
  encodes decoded frames through OpenCV's FFmpeg backend. When no backend
  can open the sink, the toggle stays tracked and a warning is logged
  once: the same control-plane state, a degraded transport.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Deque, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger

log = get_logger("ingest.passthrough")


class PacketPassthroughWriter:
    """Stream-copy relay: compressed packets in, FLV/RTMP (or any
    libav-muxable sink) out. Fed every demuxed packet via ``feed`` whether
    or not the toggle is on — the current GOP stays buffered so toggle-on
    starts the remote stream at a keyframe (reference
    ``rtsp_to_rtmp.py:136-139,155-157``)."""

    # A failed sink open retries while the toggle stays on (a slow-to-boot
    # RTMP ingest must not require an operator re-toggle), but not on every
    # packet — connect attempts to a dead endpoint block for the protocol
    # timeout.
    RETRY_COOLDOWN_S = 2.0

    def __init__(self, endpoint: str, info, audio_info=None,
                 max_buffer_bytes: int = 16 << 20):
        self.endpoint = endpoint
        self.info = info                     # av.StreamInfo of the source
        # Camera-mic audio rides the relay when present (reference
        # rtsp_to_rtmp.py:87-89,170-180); audio packets buffer in the GOP
        # alongside video and rebase on their own stream clock.
        self.audio_info = audio_info
        self._gop: Deque = deque()           # av.Packet of the current GOP
        self._gop_bytes = 0
        self._max_buffer_bytes = max_buffer_bytes
        self._mux = None
        self._base_ts: Optional[int] = None  # first valid relayed dts -> 0
        self._base_ats: Optional[int] = None  # audio clock's own base
        self._started = False                # keyframe seen on this sink
        self._failed = False
        self._failed_at = 0.0
        self.requested = False
        self.active = False
        self.written = 0

    @staticmethod
    def _format_for(endpoint: str) -> str:
        if endpoint.startswith(("rtmp://", "rtmps://")):
            return "flv"     # the container RTMP carries
        return ""            # local file sinks: guess from extension

    def feed(self, pkt) -> None:
        """One demuxed packet (with payload; video or audio). Buffers the
        GOP; relays live when active. Only VIDEO keyframes reset the
        buffer — AAC marks every packet KEY, and clearing on those would
        drop the buffered GOP head."""
        if pkt.is_keyframe and not getattr(pkt, "is_audio", False):
            self._gop.clear()
            self._gop_bytes = 0
        self._gop.append(pkt)
        self._gop_bytes += len(pkt.data)
        if self._gop_bytes > self._max_buffer_bytes:
            # Oversized GOP: drop the WHOLE buffer, never just its head —
            # a buffer without its keyframe would flush an undecodable
            # prefix on toggle-on. An empty buffer makes _write wait for
            # the next keyframe instead.
            self._gop.clear()
            self._gop_bytes = 0
        if self.active:
            self._write(pkt)

    def reset(self, info, audio_info=None) -> None:
        """Source reconnected: new demuxer, new timestamps, possibly new
        codec parameters. Buffered packets from the dead stream must not be
        flushed into a sink built from the new info, and a live relay must
        restart its mux so rebasing starts from the new stream's clock
        (otherwise the first post-reconnect write produces wildly
        non-monotonic timestamps and kills the sink)."""
        self.info = info
        self.audio_info = audio_info
        self._gop.clear()
        self._gop_bytes = 0
        if self.requested:
            # Resume a relay the operator still wants: a stream drop is not
            # a toggle-off. Reopen cleanly; failure follows the usual
            # tracked-but-off path.
            self._close()
            self._failed = False
            self.active = self._open()
        else:
            self._close()
            self.active = False

    def set_active(self, active: bool) -> None:
        if active == self.requested:
            if (
                active and not self.active and self._failed
                and time.monotonic() - self._failed_at > self.RETRY_COOLDOWN_S
            ):
                # Toggle still on but transport down (sink wasn't up yet,
                # or died mid-relay): retry instead of staying dead until
                # an operator re-toggles.
                self._failed = False
                if self._open():
                    self.active = True
                    for pkt in self._gop:
                        self._write(pkt)
                    log.info(
                        "packet passthrough to %s recovered (flushed %d "
                        "buffered packets)", self.endpoint, len(self._gop),
                    )
            return
        self.requested = active
        if not active:
            self.active = False
            self._failed = False   # a fresh toggle-on retries the sink
            self._close()
            log.info("packet passthrough to %s stopped", self.endpoint)
            return
        if self._open():
            self.active = True
            # Everything currently buffered (from the GOP-head keyframe on)
            # goes first so the sink starts decodable; the caller feeds the
            # in-flight packet only after this returns, so nothing is
            # relayed twice (reference rtsp_to_rtmp.py:136-139,163-182).
            for pkt in self._gop:
                self._write(pkt)
            log.info(
                "packet passthrough to %s started (flushed %d buffered "
                "packets)", self.endpoint, len(self._gop),
            )

    def _open(self) -> bool:
        if self._failed:
            return False
        from .av import StreamCopyMuxer

        if "://" not in self.endpoint:
            os.makedirs(os.path.dirname(self.endpoint) or ".", exist_ok=True)
        try:
            self._mux = StreamCopyMuxer(
                self.endpoint, self.info,
                format=self._format_for(self.endpoint),
                audio_info=self.audio_info,
            )
        except IOError as exc:
            self._fail(str(exc))
            return False
        self._base_ts = None
        self._base_ats = None
        self._started = False
        return True

    def _write(self, pkt) -> None:
        if self._mux is None:
            return
        is_audio = getattr(pkt, "is_audio", False)
        if not self._started:
            if is_audio or not pkt.is_keyframe:
                # Fresh sink with nothing flushed yet (oversized-GOP drop,
                # or a reconnect resume): the remote stream must begin at a
                # VIDEO keyframe to be decodable — hold until the next GOP
                # head (audio joins right after it).
                return
            self._started = True
        if self._base_ts is None and not is_audio:
            # RTSP sources emit AV_NOPTS (None here) on early packets;
            # rebase from the first packet carrying any real timestamp
            # (dts, else pts — equal at a GOP head) so a head with pts
            # but no dts doesn't go out huge-and-unrebased followed by
            # rebased ~0 packets (non-monotonic ts kills the sink).
            # Both-None packets pass through for libav to derive.
            ts = pkt.dts if pkt.dts is not None else pkt.pts
            if ts is not None:
                self._base_ts = ts
        if self._base_ats is None and is_audio:
            # The audio stream runs its own clock; rebase it separately.
            ts = pkt.dts if pkt.dts is not None else pkt.pts
            if ts is not None:
                self._base_ats = ts
        try:
            self._mux.write(
                pkt,
                ts_offset=(self._base_ats if is_audio else self._base_ts)
                or 0,
            )
            self.written += 1
        except IOError as exc:
            self._fail(str(exc))
            self._close()

    def _fail(self, why: str) -> None:
        if not self._failed:
            log.warning(
                "RTMP packet passthrough to %s unavailable (%s); toggle "
                "state tracked, transport retries every %.0fs while the "
                "toggle stays on", self.endpoint, why, self.RETRY_COOLDOWN_S,
            )
        self._failed = True
        self._failed_at = time.monotonic()
        self.active = False

    def _close(self) -> None:
        if self._mux is not None:
            try:
                self._mux.close()
            except IOError as exc:
                log.warning("closing passthrough sink failed: %s", exc)
            self._mux = None

    def close(self) -> None:
        self._close()
        self.active = False


class PassthroughWriter:
    """Owns the sink lifecycle; fed one decoded frame at a time."""

    def __init__(self, endpoint: str, fps: float = 30.0,
                 max_buffer_bytes: int = 64 << 20):
        self.endpoint = endpoint
        self.fps = max(fps, 1.0)
        self._writer = None
        self._writer_wh: Optional[Tuple[int, int]] = None
        self._failed = False
        # Rolling buffer of the current GOP (reset at each keyframe) so
        # toggle-on can flush from the GOP head (reference :155-157).
        # Byte-bounded: we hold decoded frames where the reference held
        # compressed packets, so an unbounded GOP would be GBs at 1080p.
        self._gop: Deque[Tuple[np.ndarray, bool]] = deque()
        self._gop_bytes = 0
        self._max_buffer_bytes = max_buffer_bytes
        self.requested = False   # control-plane toggle state (always tracked)
        self.active = False      # transport actually relaying
        self.written = 0

    # -- GOP buffering (references, not copies; byte-capped) --

    def buffer(self, frame: np.ndarray, is_keyframe: bool) -> None:
        if self._failed:
            return
        if is_keyframe:
            self._gop.clear()
            self._gop_bytes = 0
        self._gop.append((frame, is_keyframe))
        self._gop_bytes += frame.nbytes
        while self._gop_bytes > self._max_buffer_bytes and len(self._gop) > 1:
            old, _ = self._gop.popleft()
            self._gop_bytes -= old.nbytes

    # -- toggle + relay --

    def set_active(self, active: bool) -> None:
        if active == self.requested:
            return
        self.requested = active
        if not active:
            self.active = False
            self._failed = False   # a fresh toggle-on retries the sink
            self._close()
            log.info("passthrough to %s stopped", self.endpoint)
            return
        if self._open():
            self.active = True
            # Flush the buffered GOP so the sink starts at a keyframe
            # (reference rtsp_to_rtmp.py:136-139,163-182).
            for frame, _ in self._gop:
                self._write(frame)
            log.info(
                "passthrough to %s started (flushed %d buffered frames)",
                self.endpoint, len(self._gop),
            )

    def relay(self, frame: np.ndarray) -> None:
        if self.active:
            self._write(frame)   # opens the sink lazily on the first frame

    # -- sink plumbing --

    def _open(self) -> bool:
        if self._failed:
            return False
        try:
            import cv2
        except ImportError:
            self._fail("OpenCV unavailable")
            return False
        if not self._gop:
            return True  # open lazily on the first frame
        h, w = self._gop[-1][0].shape[:2]
        return self._open_writer(w, h)

    def _open_writer(self, w: int, h: int) -> bool:
        import cv2

        is_url = "://" in self.endpoint
        fourcc = cv2.VideoWriter_fourcc(*("FLV1" if is_url else "mp4v"))
        if not is_url:
            os.makedirs(os.path.dirname(self.endpoint) or ".", exist_ok=True)
        writer = cv2.VideoWriter(self.endpoint, fourcc, self.fps, (w, h))
        if not writer.isOpened():
            self._fail("no encoder backend for this sink")
            return False
        self._writer = writer
        self._writer_wh = (w, h)
        return True

    def _write(self, frame: np.ndarray) -> None:
        if self._failed:
            return
        wh = (frame.shape[1], frame.shape[0])
        if self._writer is not None and wh != self._writer_wh:
            # Camera switched modes mid-stream (worker grows its ring for
            # the same reason); cv2 silently drops mis-sized frames, so
            # reopen the sink at the new geometry instead of going dead.
            log.info(
                "passthrough sink %s reopening for %dx%d",
                self.endpoint, wh[0], wh[1],
            )
            self._close()
        if self._writer is None:
            if not self._open_writer(*wh):
                return
        self._writer.write(frame)
        self.written += 1

    def _fail(self, why: str) -> None:
        if not self._failed:
            log.warning(
                "RTMP passthrough to %s unavailable (%s); toggle state is "
                "tracked only, transport off until re-toggled",
                self.endpoint, why,
            )
        self._failed = True
        # Transport is dead: do NOT hold the worker's decode gate open.
        # `requested` keeps the control-plane toggle observable.
        self.active = False

    def _close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def close(self) -> None:
        self._close()
        self.active = False

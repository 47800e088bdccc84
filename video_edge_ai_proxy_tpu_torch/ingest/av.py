"""ctypes binding over the native libav shim (``native/vepav.cpp``);
counterpart of ``video_edge_ai_proxy_tpu/ingest/av.py``.

The packet-level media layer the reference reaches through PyAV: true
demux (real ``packet.is_keyframe``, pts/dts/time_base), lazy decode to
BGR24, stream-copy muxing for MP4 archive segments and FLV/RTMP relay,
and a BGR24 H.264 encoder (fixtures and re-encode fallbacks). The shim
links the system FFmpeg libraries (``-lavformat -lavcodec -lavutil
-lswscale``) and is built from the port's own ``native/vepav.cpp`` at its
first use (``_load``, through ``utils/cbuild.py`` into ``build/native/``),
never at import.

``available()`` is False when the toolchain or the FFmpeg development
files are missing; ``sources.open_source`` then routes cameras to the
OpenCV source, as the JAX package does. The module imports numpy and
ctypes only: a worker process that loads it loads no torch.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..utils.cbuild import build_library
from ..utils.logging import get_logger

log = get_logger("ingest.av")

_SRC = os.path.join(os.path.dirname(__file__), "native", "vepav.cpp")
_LDFLAGS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

VA_EOF = 1
_ERRCAP = 256


class _CStreamInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("codec_id", ctypes.c_int32),
        ("tb_num", ctypes.c_int32),
        ("tb_den", ctypes.c_int32),
        ("fps_num", ctypes.c_int32),
        ("fps_den", ctypes.c_int32),
        ("extradata_len", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("codec_name", ctypes.c_char * 32),
    ]


class _CPacketMeta(ctypes.Structure):
    _fields_ = [
        ("pts", ctypes.c_int64),
        ("dts", ctypes.c_int64),
        ("duration", ctypes.c_int64),
        ("size", ctypes.c_int32),
        ("is_keyframe", ctypes.c_int32),
        ("is_corrupt", ctypes.c_int32),
        ("is_audio", ctypes.c_int32),
    ]


class _CFrameMeta(ctypes.Structure):
    _fields_ = [
        ("pts", ctypes.c_int64),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("is_keyframe", ctypes.c_int32),
        ("pict_type", ctypes.c_int32),
    ]


_lib = None
_lib_error: Optional[str] = None
_lock = threading.Lock()


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _load() -> ctypes.CDLL:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(_lib_error)
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build_library(_SRC, "vepav", _LDFLAGS))
        except (RuntimeError, OSError) as exc:
            _lib_error = f"vepav unavailable: {exc}"
            raise RuntimeError(_lib_error) from exc
        p8 = ctypes.POINTER(ctypes.c_uint8)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.va_open.restype = vp
        lib.va_open.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_char_p, ctypes.c_char_p, i32,
        ]
        lib.va_stream_info.argtypes = [vp, ctypes.POINTER(_CStreamInfo)]
        lib.va_audio_info.argtypes = [vp, ctypes.POINTER(_CStreamInfo)]
        lib.va_extradata.argtypes = [vp, p8, i32]
        lib.va_audio_extradata.argtypes = [vp, p8, i32]
        lib.va_read.argtypes = [vp, ctypes.POINTER(_CPacketMeta)]
        lib.va_pkt_data.argtypes = [vp, p8, i32]
        lib.va_decode.argtypes = [vp, p8, i64, ctypes.POINTER(_CFrameMeta)]
        lib.va_decode_drain.argtypes = [vp, p8, i64, ctypes.POINTER(_CFrameMeta)]
        lib.va_close.argtypes = [vp]
        lib.vm_open.restype = vp
        lib.vm_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(_CStreamInfo),
            p8, i32, ctypes.POINTER(_CStreamInfo), p8, i32,
            ctypes.c_char_p, ctypes.c_char_p, i32,
        ]
        lib.vm_write.argtypes = [vp, p8, i32, i64, i64, i64, i32]
        lib.vm_write_audio.argtypes = [vp, p8, i32, i64, i64, i64]
        lib.vm_close.argtypes = [vp]
        lib.vca_open.restype = vp
        lib.vca_open.argtypes = [
            ctypes.c_char_p, i32, i32, ctypes.c_char_p, i32,
        ]
        lib.vca_frame_size.argtypes = [vp]
        lib.vca_info.argtypes = [vp, ctypes.POINTER(_CStreamInfo)]
        lib.vca_extradata.argtypes = [vp, p8, i32]
        lib.vca_send.argtypes = [vp, ctypes.POINTER(ctypes.c_float), i64]
        lib.vca_receive.argtypes = [vp, ctypes.POINTER(_CPacketMeta), p8, i32]
        lib.vca_close.argtypes = [vp]
        lib.vc_open.restype = vp
        lib.vc_open.argtypes = [
            ctypes.c_char_p, i32, i32, i32, i32, i32, i64, i32,
            ctypes.c_char_p, i32,
        ]
        lib.vc_info.argtypes = [vp, ctypes.POINTER(_CStreamInfo)]
        lib.vc_extradata.argtypes = [vp, p8, i32]
        lib.vc_send.argtypes = [vp, p8, i64]
        lib.vc_receive.argtypes = [vp, ctypes.POINTER(_CPacketMeta), p8, i32]
        lib.vc_close.argtypes = [vp]
        lib.va_encoder_available.argtypes = [ctypes.c_char_p]
        lib.va_strerror.argtypes = [i32, ctypes.c_char_p, i32]
        lib.va_set_log_level.argtypes = [i32]
        lib.va_set_log_level(16)  # AV_LOG_ERROR
        _lib = lib
    return _lib


def available() -> bool:
    """True when the native shim builds and loads on this host."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def encoder_available(name: str = "libx264") -> bool:
    try:
        return bool(_load().va_encoder_available(name.encode()))
    except RuntimeError:
        return False


def _strerror(code: int) -> str:
    buf = ctypes.create_string_buffer(_ERRCAP)
    try:
        _load().va_strerror(code, buf, _ERRCAP)
        return buf.value.decode(errors="replace")
    except RuntimeError:
        return f"averror {code}"


@dataclass
class StreamInfo:
    width: int
    height: int
    codec_id: int
    codec_name: str
    time_base: Tuple[int, int]     # (num, den) of pts/dts units
    fps: float
    extradata: bytes = b""
    sample_rate: int = 0           # audio streams only
    channels: int = 0              # audio streams only

    @classmethod
    def _from_c(cls, c: _CStreamInfo, extradata: bytes = b"") -> "StreamInfo":
        den = c.fps_den or 1
        return cls(
            width=int(c.width), height=int(c.height),
            codec_id=int(c.codec_id),
            codec_name=c.codec_name.decode(errors="replace"),
            time_base=(int(c.tb_num), int(c.tb_den) or 1),
            fps=(c.fps_num / den) if c.fps_num else 0.0,
            extradata=extradata,
            sample_rate=int(c.sample_rate),
            channels=int(c.channels),
        )

    def _to_c(self) -> _CStreamInfo:
        c = _CStreamInfo()
        c.width, c.height = self.width, self.height
        c.codec_id = self.codec_id
        c.tb_num, c.tb_den = self.time_base
        fps = self.fps or 30.0
        c.fps_num, c.fps_den = int(round(fps * 1000)), 1000
        c.extradata_len = len(self.extradata)
        c.sample_rate = self.sample_rate
        c.channels = self.channels
        c.codec_name = self.codec_name.encode()[:31]
        return c


# libav's "no timestamp" sentinel (INT64_MIN). Mapped to None at this
# boundary: arithmetic on the raw sentinel (rebasing, spans) silently
# wraps int64 into garbage timestamps, and RTSP sources DO emit it on
# early packets. Mux.write maps None back so libav's own rescale
# handles it.
AV_NOPTS_VALUE = -(2 ** 63)


def _ts(v: int) -> Optional[int]:
    v = int(v)
    return None if v == AV_NOPTS_VALUE else v


@dataclass
class Packet:
    """One demuxed compressed packet (timestamps in its OWN stream's
    time_base — audio and video run different clocks). ``pts``/``dts``
    are None when the source supplied no timestamp (libav
    AV_NOPTS_VALUE); ``is_audio`` marks packets of the demuxed audio
    stream (stream-copy consumers only — never decoded here)."""

    pts: Optional[int]
    dts: Optional[int]
    duration: int
    is_keyframe: bool
    is_corrupt: bool
    data: bytes
    is_audio: bool = False


class PacketDemuxer:
    """Demux-only reader with optional per-packet decode — the two-phase
    lazy split of the reference worker, at packet granularity."""

    def __init__(self, url: str, timeout_s: float = 5.0, options: str = ""):
        """``options``: extra "k=v:k=v" AVOptions for the demuxer/protocol
        (e.g. ``rtsp_flags=listen`` to accept a pushed RTSP session)."""
        lib = _load()
        err = ctypes.create_string_buffer(_ERRCAP)
        self._h = lib.va_open(
            url.encode(), int(timeout_s * 1e6), options.encode(), err, _ERRCAP
        )
        if not self._h:
            raise ConnectionError(
                f"failed to open {url!r}: {err.value.decode(errors='replace')}"
            )
        self._lib = lib
        c = _CStreamInfo()
        lib.va_stream_info(self._h, ctypes.byref(c))
        extradata = b""
        if c.extradata_len > 0:
            buf = np.empty(int(c.extradata_len), np.uint8)
            n = lib.va_extradata(self._h, _u8(buf), buf.nbytes)
            extradata = bytes(buf[:n]) if n > 0 else b""
        self.info = StreamInfo._from_c(c, extradata)
        # Audio stream (camera mic), when present: stream-copy consumers
        # (archive mux, RTMP relay) carry it through; None otherwise.
        self.audio_info: Optional[StreamInfo] = None
        ca = _CStreamInfo()
        if lib.va_audio_info(self._h, ctypes.byref(ca)) == 0:
            a_extra = b""
            if ca.extradata_len > 0:
                buf = np.empty(int(ca.extradata_len), np.uint8)
                n = lib.va_audio_extradata(self._h, _u8(buf), buf.nbytes)
                a_extra = bytes(buf[:n]) if n > 0 else b""
            self.audio_info = StreamInfo._from_c(ca, a_extra)
        self._meta = _CPacketMeta()
        self._fmeta = _CFrameMeta()
        w = max(self.info.width, 16)
        h = max(self.info.height, 16)
        self._frame_buf = np.empty(w * h * 3, np.uint8)
        self.last_frame_pts: Optional[int] = 0
        self.last_frame_type: str = ""

    def read(self, want_data: bool = False) -> Optional[Packet]:
        """Next video packet; None at EOF. ``want_data=False`` skips the
        payload copy (pure demux — the gate-closed hot path)."""
        if self._h is None:
            return None
        rc = self._lib.va_read(self._h, ctypes.byref(self._meta))
        if rc == VA_EOF:
            return None
        if rc < 0:
            raise IOError(f"demux error: {_strerror(rc)}")
        m = self._meta
        data = b""
        if want_data and m.size > 0:
            buf = np.empty(int(m.size), np.uint8)
            n = self._lib.va_pkt_data(self._h, _u8(buf), buf.nbytes)
            data = bytes(buf[:n]) if n > 0 else b""
        return Packet(
            pts=_ts(m.pts), dts=_ts(m.dts), duration=int(m.duration),
            is_keyframe=bool(m.is_keyframe), is_corrupt=bool(m.is_corrupt),
            data=data, is_audio=bool(m.is_audio),
        )

    def packet_data(self) -> bytes:
        """Compressed payload of the current packet (GOP buffering)."""
        m = self._meta
        if m.size <= 0:
            return b""
        buf = np.empty(int(m.size), np.uint8)
        n = self._lib.va_pkt_data(self._h, _u8(buf), buf.nbytes)
        return bytes(buf[:n]) if n > 0 else b""

    _PICT = {1: "I", 2: "P", 3: "B"}

    def _finish_frame(self, n: int) -> np.ndarray:
        fm = self._fmeta
        self.last_frame_pts = _ts(fm.pts)
        self.last_frame_type = self._PICT.get(int(fm.pict_type), "")
        h, w = int(fm.height), int(fm.width)
        return self._frame_buf[:n].reshape(h, w, 3).copy()

    def _decode_call(self, fn) -> Optional[np.ndarray]:
        for _ in range(2):  # at most one ENOSPC resize retry
            n = fn(
                self._h, _u8(self._frame_buf), self._frame_buf.nbytes,
                ctypes.byref(self._fmeta),
            )
            if n == 0:
                return None
            if n > 0:
                return self._finish_frame(n)
            if n == -28:
                # AVERROR(ENOSPC): camera switched to a larger mode. The
                # shim keeps the dequeued frame pending and reports its
                # real dimensions in fmeta; resize and retry converts it.
                self._frame_buf = np.empty(
                    int(self._fmeta.width) * int(self._fmeta.height) * 3,
                    np.uint8,
                )
                continue
            raise IOError(f"decode error: {_strerror(n)}")
        raise IOError(
            f"decode buffer retry failed at "
            f"{self._fmeta.width}x{self._fmeta.height}"
        )

    def decode(self) -> Optional[np.ndarray]:
        """Decode the current packet to BGR24; None while the codec needs
        more input (delay, or a mid-GOP join waiting for the next IDR)."""
        return self._decode_call(self._lib.va_decode)

    def drain(self) -> Optional[np.ndarray]:
        """Flush one delayed frame at EOF; None when empty."""
        return self._decode_call(self._lib.va_decode_drain)

    def close(self) -> None:
        if self._h is not None:
            self._lib.va_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()


class StreamCopyMuxer:
    """Writes compressed packets into MP4/FLV/RTMP without transcoding —
    bit-exact, ~zero CPU (reference ``python/archive.py:75-100`` and
    ``rtsp_to_rtmp.py:163-182``). With ``audio_info`` the container
    carries the camera's audio stream too (reference audio carry-through,
    ``archive.py:78-79``, ``rtsp_to_rtmp.py:87-89``); audio packets route
    by ``Packet.is_audio`` and rebase in THEIR stream's time base."""

    def __init__(self, url: str, info: StreamInfo, format: str = "",
                 options: str = "", audio_info: Optional[StreamInfo] = None):
        """``options`` is a "k=v:k=v" AVOption string for the muxer/protocol
        (e.g. ``rtsp_flags=listen`` makes the RTSP muxer serve one client —
        the tests' stand-in for a real camera)."""
        lib = _load()
        err = ctypes.create_string_buffer(_ERRCAP)
        c = info._to_c()
        extra = np.frombuffer(info.extradata, np.uint8).copy() if info.extradata \
            else np.empty(0, np.uint8)
        ca = audio_info._to_c() if audio_info is not None else None
        a_extra = (
            np.frombuffer(audio_info.extradata, np.uint8).copy()
            if audio_info is not None and audio_info.extradata
            else np.empty(0, np.uint8)
        )
        self._h = lib.vm_open(
            url.encode(), format.encode(), ctypes.byref(c),
            _u8(extra) if extra.size else None, extra.size,
            ctypes.byref(ca) if ca is not None else None,
            _u8(a_extra) if a_extra.size else None, a_extra.size,
            options.encode(), err, _ERRCAP,
        )
        if not self._h:
            raise IOError(
                f"failed to open muxer {url!r}: "
                f"{err.value.decode(errors='replace')}"
            )
        self._lib = lib
        self.has_audio = audio_info is not None
        self.packets = 0
        self.audio_packets = 0

    def write(self, pkt: Packet, ts_offset: int = 0) -> None:
        """Write one packet; ``ts_offset`` rebases pts/dts in the PACKET's
        own stream time base (the archive rebases each segment to 0 like
        the reference, archive.py:81-84 — but per stream, since audio and
        video clocks differ). A None pts/dts goes through as
        AV_NOPTS_VALUE unrebased — av_packet_rescale_ts preserves the
        sentinel and the muxer derives what it can. Audio packets on a
        video-only muxer are dropped silently (reference behavior when no
        audio output stream exists, rtsp_to_rtmp.py:174-180)."""
        data = np.frombuffer(pkt.data, np.uint8)
        if pkt.is_audio:
            if not self.has_audio:
                return
            rc = self._lib.vm_write_audio(
                self._h, _u8(data), data.size,
                AV_NOPTS_VALUE if pkt.pts is None else pkt.pts - ts_offset,
                AV_NOPTS_VALUE if pkt.dts is None else pkt.dts - ts_offset,
                max(pkt.duration, 0),
            )
            if rc < 0:
                raise IOError(f"mux audio write error: {_strerror(rc)}")
            self.audio_packets += 1
            return
        rc = self._lib.vm_write(
            self._h, _u8(data), data.size,
            AV_NOPTS_VALUE if pkt.pts is None else pkt.pts - ts_offset,
            AV_NOPTS_VALUE if pkt.dts is None else pkt.dts - ts_offset,
            max(pkt.duration, 0), int(pkt.is_keyframe),
        )
        if rc < 0:
            raise IOError(f"mux write error: {_strerror(rc)}")
        self.packets += 1

    def close(self) -> None:
        if self._h is not None:
            rc = self._lib.vm_close(self._h)
            self._h = None
            if rc < 0:
                raise IOError(f"mux close error: {_strerror(rc)}")

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()


class Encoder:
    """BGR24 -> compressed video packets (libx264 by default)."""

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 gop: int = 30, codec: str = "libx264", bitrate: int = 0,
                 global_header: bool = True):
        lib = _load()
        err = ctypes.create_string_buffer(_ERRCAP)
        fps_num, fps_den = int(round(fps * 1000)), 1000
        self._h = lib.vc_open(
            codec.encode(), width, height, fps_num, fps_den, gop,
            bitrate, int(global_header), err, _ERRCAP,
        )
        if not self._h:
            raise IOError(
                f"failed to open encoder {codec!r}: "
                f"{err.value.decode(errors='replace')}"
            )
        self._lib = lib
        c = _CStreamInfo()
        lib.vc_info(self._h, ctypes.byref(c))
        extradata = b""
        if c.extradata_len > 0:
            buf = np.empty(int(c.extradata_len), np.uint8)
            n = lib.vc_extradata(self._h, _u8(buf), buf.nbytes)
            extradata = bytes(buf[:n]) if n > 0 else b""
        self.info = StreamInfo._from_c(c, extradata)
        self._meta = _CPacketMeta()
        self._buf = np.empty(width * height * 3 + (1 << 16), np.uint8)

    def _receive_all(self) -> list[Packet]:
        out = []
        while True:
            n = self._lib.vc_receive(
                self._h, ctypes.byref(self._meta), _u8(self._buf),
                self._buf.nbytes,
            )
            if n in (0, VA_EOF):
                return out
            if n < 0:
                raise IOError(f"encode error: {_strerror(n)}")
            m = self._meta
            out.append(Packet(
                pts=_ts(m.pts), dts=_ts(m.dts), duration=int(m.duration),
                is_keyframe=bool(m.is_keyframe), is_corrupt=False,
                data=bytes(self._buf[:n]),
            ))

    def encode(self, bgr: np.ndarray, pts: int = -1) -> list[Packet]:
        arr = np.ascontiguousarray(bgr)
        rc = self._lib.vc_send(self._h, _u8(arr), pts)
        if rc < 0:
            raise IOError(f"encode send error: {_strerror(rc)}")
        return self._receive_all()

    def flush(self) -> list[Packet]:
        self._lib.vc_send(self._h, None, -1)
        return self._receive_all()

    def close(self) -> None:
        if self._h is not None:
            self._lib.vc_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()


class AudioEncoder:
    """Interleaved float PCM -> compressed audio packets (AAC by default).
    Exists for audio-bearing test fixtures (no ffmpeg command line needed)
    and re-encode fallbacks; camera audio itself is always stream copy."""

    def __init__(self, sample_rate: int = 48000, channels: int = 1,
                 codec: str = "aac"):
        lib = _load()
        err = ctypes.create_string_buffer(_ERRCAP)
        self._h = lib.vca_open(
            codec.encode(), sample_rate, channels, err, _ERRCAP
        )
        if not self._h:
            raise IOError(
                f"failed to open audio encoder {codec!r}: "
                f"{err.value.decode(errors='replace')}"
            )
        self._lib = lib
        self.frame_size = int(lib.vca_frame_size(self._h))
        self.channels = channels
        c = _CStreamInfo()
        lib.vca_info(self._h, ctypes.byref(c))
        extradata = b""
        if c.extradata_len > 0:
            buf = np.empty(int(c.extradata_len), np.uint8)
            n = lib.vca_extradata(self._h, _u8(buf), buf.nbytes)
            extradata = bytes(buf[:n]) if n > 0 else b""
        self.info = StreamInfo._from_c(c, extradata)
        self._meta = _CPacketMeta()
        self._buf = np.empty(1 << 16, np.uint8)

    def _receive_all(self) -> list[Packet]:
        out = []
        while True:
            n = self._lib.vca_receive(
                self._h, ctypes.byref(self._meta), _u8(self._buf),
                self._buf.nbytes,
            )
            if n in (0, VA_EOF):
                return out
            if n < 0:
                raise IOError(f"audio encode error: {_strerror(n)}")
            m = self._meta
            out.append(Packet(
                pts=_ts(m.pts), dts=_ts(m.dts), duration=int(m.duration),
                is_keyframe=True, is_corrupt=False,
                data=bytes(self._buf[:n]), is_audio=True,
            ))

    def encode(self, pcm: np.ndarray, pts: int = -1) -> list[Packet]:
        """``pcm``: float32 [frame_size * channels] interleaved samples."""
        arr = np.ascontiguousarray(pcm, dtype=np.float32)
        if arr.size != self.frame_size * self.channels:
            raise ValueError(
                f"need exactly {self.frame_size * self.channels} samples, "
                f"got {arr.size}"
            )
        rc = self._lib.vca_send(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts
        )
        if rc < 0:
            raise IOError(f"audio encode send error: {_strerror(rc)}")
        return self._receive_all()

    def flush(self) -> list[Packet]:
        self._lib.vca_send(self._h, None, -1)
        return self._receive_all()

    def close(self) -> None:
        if self._h is not None:
            self._lib.vca_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()


def write_test_video(path: str, width: int = 320, height: int = 240,
                     frames: int = 60, fps: float = 30.0, gop: int = 10,
                     codec: str = "libx264", audio: bool = False,
                     sample_rate: int = 48000) -> StreamInfo:
    """Encode a deterministic moving pattern to ``path`` (container guessed
    from the extension). The synthetic *encoded* fixture SURVEY.md §4 calls
    for — real GOP structure, real keyframe flags, no cameras needed.
    ``audio=True`` interleaves a 440 Hz AAC sine track (mono) covering the
    same duration — the audio-bearing camera fixture for the carry-through
    tests."""
    enc = Encoder(width, height, fps=fps, gop=gop, codec=codec)
    aenc = AudioEncoder(sample_rate=sample_rate, channels=1) if audio else None
    with enc:
        mux = StreamCopyMuxer(
            path, enc.info,
            audio_info=aenc.info if aenc is not None else None,
        )
        with mux:
            apts = 0
            total_samples = int(frames / fps * sample_rate) if audio else 0
            yy = np.mgrid[0:height, 0:width][0]
            for i in range(frames):
                frame = np.empty((height, width, 3), np.uint8)
                frame[:, :, 0] = ((yy + 3 * i) & 0xFF).astype(np.uint8)
                frame[:, :, 1] = (i * 5) & 0xFF
                frame[:, :, 2] = 128
                size = max(8, height // 6)
                x = (i * 11) % max(1, width - size)
                frame[height // 4 : height // 4 + size, x : x + size] = 255
                for pkt in enc.encode(frame, pts=i):
                    mux.write(pkt)
                # Keep the audio clock abreast of the video clock so the
                # muxer interleaves naturally.
                while aenc is not None and apts < total_samples \
                        and apts <= i / fps * sample_rate:
                    t = (np.arange(aenc.frame_size) + apts) / sample_rate
                    tone = (0.25 * np.sin(2 * np.pi * 440.0 * t)).astype(
                        np.float32)
                    for pkt in aenc.encode(tone, pts=apts):
                        mux.write(pkt)
                    apts += aenc.frame_size
            for pkt in enc.flush():
                mux.write(pkt)
            if aenc is not None:
                for pkt in aenc.flush():
                    mux.write(pkt)
                aenc.close()
        return enc.info

"""Shared-memory frame bus: ctypes binding over the native vepbus library.

Counterpart of ``video_edge_ai_proxy_tpu/bus/shm_bus.py``. One mmapped ring
file per camera (``<shm_dir>/<device_id>.ring``), one control KV
(``<shm_dir>/control.kv``) and one publish doorbell (``doorbell.db``). Every
process on the host (the ingest workers, the engine) maps the same files;
the frame hot path is one memcpy with seqlock validation: no broker, no
sockets, no syscalls. The files are byte-compatible with the JAX package's
bus, so either package's producers and consumers can share a directory.

The library (``bus/native/vepbus.cpp``) is built with ``g++`` by the first
``ShmFrameBus`` of a process, into ``build/native/``. A ring is a sparse
file of ``ring_bytes``: on a tmpfs that cannot hold all the rings, the
first write past the limit is a SIGBUS in a producer, so whoever starts
the producers checks the directory's room for their sum.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
from typing import Optional

import numpy as np

from ..utils.config import BusConfig
from .interface import (
    FRAME_TYPE_CODES,
    FRAME_TYPE_NAMES,
    Frame,
    FrameBus,
    FrameMeta,
    RingSlotTooSmall,
    note_publish,
)
from .native.build import build_library

log = logging.getLogger("vep.torch.bus.shm")


class _CFrameMeta(ctypes.Structure):
    # Mirrors FrameMeta in bus/native/vepbus.cpp.
    _fields_ = [
        ("width", ctypes.c_int64),
        ("height", ctypes.c_int64),
        ("channels", ctypes.c_int64),
        ("timestamp_ms", ctypes.c_int64),
        ("pts", ctypes.c_int64),
        ("dts", ctypes.c_int64),
        ("packet", ctypes.c_int64),
        ("keyframe_cnt", ctypes.c_int64),
        ("is_keyframe", ctypes.c_int32),
        ("is_corrupt", ctypes.c_int32),
        ("frame_type", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
        ("time_base", ctypes.c_double),
        ("trace_id", ctypes.c_int64),
        ("parent_span", ctypes.c_int64),
    ]


_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    u64, i64, i32, u32 = (
        ctypes.c_uint64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_uint32,
    )
    p8 = ctypes.POINTER(ctypes.c_uint8)
    lib.vb_ring_create.restype = ctypes.c_void_p
    lib.vb_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u32, u64]
    lib.vb_ring_open.restype = ctypes.c_void_p
    lib.vb_ring_open.argtypes = [ctypes.c_char_p]
    lib.vb_ring_close.argtypes = [ctypes.c_void_p]
    lib.vb_ring_slot_size.restype = u64
    lib.vb_ring_slot_size.argtypes = [ctypes.c_void_p]
    lib.vb_ring_head.restype = u64
    lib.vb_ring_head.argtypes = [ctypes.c_void_p]
    lib.vb_ring_publish.restype = u64
    lib.vb_ring_publish.argtypes = [
        ctypes.c_void_p, p8, u64, ctypes.POINTER(_CFrameMeta),
    ]
    lib.vb_ring_read_latest.restype = u64
    lib.vb_ring_read_latest.argtypes = [
        ctypes.c_void_p, u64, p8, u64,
        ctypes.POINTER(u64), ctypes.POINTER(_CFrameMeta),
    ]
    lib.vb_kv_open.restype = ctypes.c_void_p
    lib.vb_kv_open.argtypes = [ctypes.c_char_p, u32]
    lib.vb_kv_close.argtypes = [ctypes.c_void_p]
    lib.vb_kv_set.restype = i32
    lib.vb_kv_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p8, u32]
    lib.vb_kv_get.restype = i64
    lib.vb_kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p8, u32]
    lib.vb_kv_del.restype = i32
    lib.vb_kv_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.vb_kv_keys.restype = i64
    lib.vb_kv_keys.argtypes = [ctypes.c_void_p, p8, u64]
    lib.vb_doorbell_open.restype = ctypes.c_void_p
    lib.vb_doorbell_open.argtypes = [ctypes.c_char_p]
    lib.vb_doorbell_close.argtypes = [ctypes.c_void_p]
    lib.vb_doorbell_value.restype = u32
    lib.vb_doorbell_value.argtypes = [ctypes.c_void_p]
    lib.vb_doorbell_ring.argtypes = [ctypes.c_void_p]
    lib.vb_doorbell_wait.restype = u32
    lib.vb_doorbell_wait.argtypes = [ctypes.c_void_p, u32, u32]
    _lib = lib
    return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_RING_SUFFIX = ".ring"
_KV_SLOTS = 4096
_KV_VAL_CAP = 1024
# sizeof(RingHeader) and sizeof(SlotHeader) in vepbus.cpp.
_RING_HEADER_BYTES = 232
_SLOT_HEADER_BYTES = 24 + ctypes.sizeof(_CFrameMeta)


def ring_bytes(frame_bytes: int, slots: int) -> int:
    """Bytes of the ring file ``create_stream(.., frame_bytes, slots)``
    makes: a header, then per slot a header and the payload rounded up to
    64 bytes."""
    return _RING_HEADER_BYTES + slots * (_SLOT_HEADER_BYTES + ((frame_bytes + 63) & ~63))


class ShmFrameBus(FrameBus):
    def __init__(self, shm_dir: str = BusConfig.shm_dir):
        self._lib = _load()
        self._dir = shm_dir
        os.makedirs(shm_dir, exist_ok=True)
        self._rings: dict[str, int] = {}  # device_id -> handle (this process)
        self._inodes: dict[str, int] = {}  # ring inode at open/create time
        self._checked: dict[str, float] = {}  # last inode revalidation time
        self._writer: set[str] = set()
        self._writer_params: dict[str, tuple[int, int]] = {}  # (bytes, slots)
        self._kv = self._lib.vb_kv_open(
            os.path.join(shm_dir, "control.kv").encode(), _KV_SLOTS
        )
        if not self._kv:
            raise OSError(f"failed to open control KV in {shm_dir}")
        # Bus-wide publish doorbell (futex): producers ring it after every
        # vb_ring_publish; the engine's incremental batch assembler blocks
        # on it between ticks instead of sleep-polling 16 rings on a
        # 1-core host (engine/collector.py assemble_until).
        self._db = self._lib.vb_doorbell_open(
            os.path.join(shm_dir, "doorbell.db").encode()
        )
        if not self._db:
            raise OSError(f"failed to open doorbell in {shm_dir}")
        # Reusable read buffer, grown on demand. One bus instance is shared
        # by the engine's threads (the tick thread reads, the collector's
        # assembly sweep reads, keep-hot writes the KV), so the consumer
        # side needs a lock, for two reasons: (a) two threads memcpy-ing into the SAME
        # staging buffer would tear each other's copies even though the C
        # ring's seqlock never tears; (b) `_handle` revalidation and
        # `drop_stream` close native handles — without mutual exclusion two
        # readers can double-close a handle, or a drop can close one while
        # a reader is inside the C call (use-after-free). The lock covers
        # handle resolution THROUGH the copy-out, and every mutation of the
        # handle table. Reads serialize on a ~ms memcpy; ctypes releases the
        # interpreter lock inside it.
        self._buf = np.empty(4 << 20, dtype=np.uint8)
        self._expected_bytes: dict[str, int] = {}  # read_latest fast path
        self._fast_dst: dict[str, np.ndarray] = {}  # pre-alloc'd fast dst
        self._lock = threading.RLock()
        self._closed = False

    # -- paths --

    def _ring_path(self, device_id: str) -> str:
        safe = device_id.replace("/", "_")
        return os.path.join(self._dir, safe + _RING_SUFFIX)

    # -- frame plane --

    def create_stream(self, device_id: str, frame_bytes: int, slots: int = 4) -> None:
        with self._lock:
            if self._closed:
                # A creator racing close() must not cache a fresh handle the
                # close pass will never release (same rule as `_handle`).
                raise OSError("bus is closed")
            self.drop_stream(device_id)
            h = self._lib.vb_ring_create(
                self._ring_path(device_id).encode(), device_id.encode(),
                slots, frame_bytes,
            )
            if not h:
                raise OSError(f"failed to create ring for {device_id}")
            self._rings[device_id] = h
            self._writer.add(device_id)
            self._writer_params[device_id] = (frame_bytes, slots)
            try:
                self._inodes[device_id] = os.stat(
                    self._ring_path(device_id)).st_ino
            except FileNotFoundError:
                pass  # raced an unlink; revalidation in publish() recreates

    # A restarted worker re-creates its ring file, so a cached reader mapping
    # can point at a dead inode. Re-validating with os.stat on *every* read
    # would put a syscall on the per-frame hot path (belied by the module
    # header); a dead mapping only manifests as the head going quiet, so a
    # coarse revalidation interval gives the same correctness with the stat
    # off the hit path.
    _REVALIDATE_S = 0.25

    def _handle(self, device_id: str) -> Optional[int]:
        if self._closed:
            # A reader racing close() must not re-open a ring handle the
            # close pass would never see (leaked mapping).
            return None
        path = self._ring_path(device_id)
        h = self._rings.get(device_id)
        if h and device_id in self._writer:
            return h
        now = time.monotonic()
        if h and now - self._checked.get(device_id, 0.0) < self._REVALIDATE_S:
            return h
        try:
            ino = os.stat(path).st_ino
        except FileNotFoundError:
            if h:
                self._lib.vb_ring_close(h)
                self._rings.pop(device_id, None)
                self._inodes.pop(device_id, None)
                self._checked.pop(device_id, None)
            return None
        self._checked[device_id] = now
        if h and self._inodes.get(device_id) == ino:
            return h
        if h:
            self._lib.vb_ring_close(h)
            self._rings.pop(device_id, None)
        h = self._lib.vb_ring_open(path.encode())
        if not h:
            return None
        self._rings[device_id] = h
        self._inodes[device_id] = ino
        return h

    def publish(self, device_id: str, data: np.ndarray, meta: FrameMeta) -> int:
        arr = np.ascontiguousarray(data)
        cm = _CFrameMeta(
            width=meta.width or (arr.shape[1] if arr.ndim >= 2 else 0),
            height=meta.height or (arr.shape[0] if arr.ndim >= 2 else 0),
            channels=meta.channels,
            timestamp_ms=meta.timestamp_ms,
            pts=meta.pts,
            dts=meta.dts,
            packet=meta.packet,
            keyframe_cnt=meta.keyframe_cnt,
            is_keyframe=int(meta.is_keyframe),
            is_corrupt=int(meta.is_corrupt),
            frame_type=FRAME_TYPE_CODES.get(meta.frame_type, 0),
            dtype=0,
            time_base=meta.time_base,
            trace_id=meta.trace_id,
            parent_span=meta.parent_span,
        )
        with self._lock:
            if self._closed:
                raise OSError("bus is closed")
            h = self._rings.get(device_id)
            if h is None or device_id not in self._writer:
                raise ValueError(f"not the producer for stream {device_id!r}")
            h = self._writer_revalidate(device_id, h)
            seq = self._lib.vb_ring_publish(
                h, _u8ptr(arr), arr.nbytes, ctypes.byref(cm)
            )
        if seq == 0:
            raise RingSlotTooSmall(
                f"publish failed for {device_id} ({arr.nbytes} B > slot)"
            )
        self._lib.vb_doorbell_ring(self._db)
        note_publish("shm", device_id, arr.nbytes)
        return int(seq)

    def _writer_revalidate(self, device_id: str, h: int) -> int:
        """Producer-side self-heal (interval-limited stat, same cadence as
        reader revalidation): if the ring file was unlinked/replaced under
        this writer — a wiped shm dir, a tmpfiles cleaner, or a second
        supervisor racing for the device_id — publishing would otherwise
        continue into the orphaned mapping forever while readers watch the
        new file stay silent. Detect the inode mismatch, log loudly, and
        re-create to reclaim the path. Called with the bus lock held."""
        now = time.monotonic()
        if now - self._checked.get(device_id, 0.0) < self._REVALIDATE_S:
            return h
        self._checked[device_id] = now
        path = self._ring_path(device_id)
        try:
            ino = os.stat(path).st_ino
        except FileNotFoundError:
            ino = None
        if ino is not None and ino == self._inodes.get(device_id):
            return h
        log.warning(
            "ring file for %s was %s under its producer; re-creating "
            "(another supervisor racing for this device_id, or the shm "
            "dir was cleaned)", device_id,
            "removed" if ino is None else "replaced",
        )
        frame_bytes, slots = self._writer_params[device_id]
        self.create_stream(device_id, frame_bytes, slots)
        return self._rings[device_id]

    def read_latest(self, device_id: str, min_seq: int = 0) -> Optional[Frame]:
        out_len = ctypes.c_uint64(0)
        cm = _CFrameMeta()
        with self._lock:
            h = self._handle(device_id)
            if h is None:
                return None
            # Fast path: the C reader writes straight into a fresh exact-
            # size destination (frame size per stream is stable), so the
            # returned array IS the read target — one memory pass, not a
            # persistent-scratch read plus a .copy(). At 16 x 1080p the
            # frame plane moves ~100 MB per tick. Geometry changes fall
            # back to the scratch path once and re-cache.
            expected = self._expected_bytes.get(device_id, 0)
            raw = None
            if expected:
                # The destination is allocated once and kept until a frame
                # is actually handed to a caller — idle ticks (seq == 0,
                # the common case) reuse it and return immediately without
                # a second C read or a multi-MB allocation.
                dst = self._fast_dst.get(device_id)
                if dst is None or dst.nbytes != expected:
                    dst = np.empty(expected, dtype=np.uint8)
                    self._fast_dst[device_id] = dst
                seq = self._lib.vb_ring_read_latest(
                    h, min_seq, _u8ptr(dst), dst.nbytes,
                    ctypes.byref(out_len), ctypes.byref(cm),
                )
                if seq == 0:            # no new frame: done, one pass
                    return None
                if seq == ctypes.c_uint64(-1).value:
                    expected = 0        # grew: take the scratch path
                elif int(out_len.value) == expected:
                    raw = dst           # zero extra copies
                    del self._fast_dst[device_id]  # caller owns it now
            if raw is None:
                while True:
                    seq = self._lib.vb_ring_read_latest(
                        h, min_seq, _u8ptr(self._buf), self._buf.nbytes,
                        ctypes.byref(out_len), ctypes.byref(cm),
                    )
                    if seq == ctypes.c_uint64(-1).value:  # buffer too small
                        self._buf = np.empty(
                            int(out_len.value) * 2, dtype=np.uint8
                        )
                        continue
                    break
                if seq != 0:
                    raw = self._buf[: int(out_len.value)].copy()
            if seq == 0:
                return None
            n = int(out_len.value)
            self._expected_bytes[device_id] = n
            h_, w_, c_ = int(cm.height), int(cm.width), int(cm.channels)
        data = raw.reshape(h_, w_, c_) if h_ * w_ * c_ == n else raw
        meta = FrameMeta(
            width=w_, height=h_, channels=c_,
            timestamp_ms=int(cm.timestamp_ms), pts=int(cm.pts), dts=int(cm.dts),
            packet=int(cm.packet), keyframe_cnt=int(cm.keyframe_cnt),
            is_keyframe=bool(cm.is_keyframe), is_corrupt=bool(cm.is_corrupt),
            frame_type=FRAME_TYPE_NAMES.get(int(cm.frame_type), ""),
            time_base=float(cm.time_base),
            trace_id=int(cm.trace_id), parent_span=int(cm.parent_span),
        )
        return Frame(seq=int(seq), data=data, meta=meta)

    def read_latest_into(self, device_id: str, dst, min_seq: int = 0):
        """Single-pass override (see interface.py): the C seqlock reader
        writes straight into ``dst`` — ring to device-batch slot with no
        intermediate frame buffer. Geometry drift (frame bytes != dst
        bytes) falls back to read_latest and returns the Frame."""
        if not dst.flags["C_CONTIGUOUS"] or dst.dtype != np.uint8:
            raise ValueError("dst must be a C-contiguous uint8 array")
        out_len = ctypes.c_uint64(0)
        cm = _CFrameMeta()
        with self._lock:
            h = self._handle(device_id)
            if h is None:
                return None
            seq = self._lib.vb_ring_read_latest(
                h, min_seq, _u8ptr(dst.reshape(-1)), dst.nbytes,
                ctypes.byref(out_len), ctypes.byref(cm),
            )
        if seq == ctypes.c_uint64(-1).value:   # frame larger than dst
            return self.read_latest(device_id, min_seq)
        if seq == 0:
            return None
        if (int(out_len.value) != dst.nbytes
                or (int(cm.height), int(cm.width), int(cm.channels))
                != dst.shape):
            # smaller frame / geometry change: dst holds a partial write —
            # re-read the frame whole so nothing serves half-written rows
            return self.read_latest(device_id, min_seq)
        self._expected_bytes[device_id] = int(out_len.value)
        meta = FrameMeta(
            width=int(cm.width), height=int(cm.height),
            channels=int(cm.channels),
            timestamp_ms=int(cm.timestamp_ms), pts=int(cm.pts),
            dts=int(cm.dts), packet=int(cm.packet),
            keyframe_cnt=int(cm.keyframe_cnt),
            is_keyframe=bool(cm.is_keyframe),
            is_corrupt=bool(cm.is_corrupt),
            frame_type=FRAME_TYPE_NAMES.get(int(cm.frame_type), ""),
            time_base=float(cm.time_base),
            trace_id=int(cm.trace_id), parent_span=int(cm.parent_span),
        )
        return int(seq), meta

    def head(self, device_id: str) -> Optional[int]:
        """Latest published seq (one C load; no copy, no meta) — the
        assembly sweep's idle-ring skip."""
        with self._lock:
            h = self._handle(device_id)
            if h is None:
                return None
            return int(self._lib.vb_ring_head(h))

    # -- doorbell --

    doorbell = True

    def doorbell_token(self) -> int:
        if self._closed:
            return 0
        return int(self._lib.vb_doorbell_value(self._db))

    def doorbell_wait(self, token: int, timeout_s: float) -> int:
        """Process-shared futex wait: returns as soon as ANY producer
        publishes (sub-100 µs wake), or after ``timeout_s``. No bus lock —
        the wait must not serialize against readers, and the C call
        releases the GIL."""
        if self._closed:
            return token
        ms = max(1, int(timeout_s * 1000))
        return int(self._lib.vb_doorbell_wait(self._db, token & 0xFFFFFFFF, ms))

    def streams(self) -> list[str]:
        out = []
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        for name in names:
            if name.endswith(_RING_SUFFIX):
                out.append(name[: -len(_RING_SUFFIX)])
        return sorted(out)

    def drop_stream(self, device_id: str) -> None:
        with self._lock:
            h = self._rings.pop(device_id, None)
            if h:
                self._lib.vb_ring_close(h)
            self._writer.discard(device_id)
            self._writer_params.pop(device_id, None)
            self._inodes.pop(device_id, None)
            self._expected_bytes.pop(device_id, None)
            self._fast_dst.pop(device_id, None)
            try:
                os.unlink(self._ring_path(device_id))
            except FileNotFoundError:
                pass

    # -- control plane --

    def kv_set(self, key: str, value: str) -> None:
        raw = value.encode()
        with self._lock:
            if not self._kv:
                raise OSError("bus is closed")
            if self._lib.vb_kv_set(self._kv, key.encode(), _u8ptr(
                    np.frombuffer(raw, dtype=np.uint8).copy()), len(raw)) != 0:
                raise OSError(
                    f"kv_set failed for {key!r} (table full / oversize)")

    def kv_get(self, key: str) -> Optional[str]:
        buf = np.empty(_KV_VAL_CAP, dtype=np.uint8)
        with self._lock:
            if not self._kv:
                return None
            n = self._lib.vb_kv_get(
                self._kv, key.encode(), _u8ptr(buf), buf.nbytes)
        if n <= 0:
            return None
        return bytes(buf[:n]).decode()

    def kv_del(self, key: str) -> None:
        with self._lock:
            if self._kv:
                self._lib.vb_kv_del(self._kv, key.encode())

    def kv_keys(self) -> list[str]:
        buf = np.empty(1 << 20, dtype=np.uint8)
        with self._lock:
            if not self._kv:
                return []
            n = self._lib.vb_kv_keys(self._kv, _u8ptr(buf), buf.nbytes)
        if n <= 0:
            return []
        return bytes(buf[:n]).decode().splitlines()

    def close(self) -> None:
        # Same lock as the read/drop paths: a thread still inside a C ring
        # read must not have its handle closed under it (the use-after-free
        # the lock exists to prevent).
        with self._lock:
            self._closed = True
            for h in self._rings.values():
                self._lib.vb_ring_close(h)
            self._rings.clear()
            if self._kv:
                self._lib.vb_kv_close(self._kv)
                self._kv = None
            if self._db:
                # Wake any waiter so nothing sleeps out a timeout against
                # a closed bus. The one-page doorbell mapping is deliberately
                # NOT unmapped: doorbell_wait runs without the bus lock (it
                # must not serialize reads), so a concurrent close would
                # otherwise race a waiter into freed memory. A page per bus
                # instance leaks until process exit, which is bounded and
                # harmless; rings/KV (the big mappings) still close.
                self._lib.vb_doorbell_ring(self._db)

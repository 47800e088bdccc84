"""Frame-bus interface and the shared key contract.

Counterpart of ``video_edge_ai_proxy_tpu/bus/interface.py``, with the same
semantics on both planes:

- frame plane: a latest-wins ring per camera, per-reader cursors (sequence
  numbers), frames as HWC uint8 BGR24. The fast path reads a frame straight
  into a slot of a pooled batch (``read_latest_into``), probes a ring's
  newest sequence number cheaply (``head``) and blocks on the publish
  doorbell between ticks (``doorbell_token`` / ``doorbell_wait``);
- control plane: a string KV with the reference's key contract:
  ``last_access_time_<id>`` is a hash with ``last_query`` / ``proxy_rtmp``
  / ``store`` fields, ``is_key_frame_only_<id>`` a boolean flag. Ingest
  workers and the engine talk through these keys only: the engine touches
  ``last_query`` of the streams it infers, and a worker decodes the frames
  between keyframes only while that stamp is fresh.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..obs import registry as obs_registry

# Control-key contract (the reference's server/models/RedisConstants.go).
KEY_LAST_ACCESS_PREFIX = "last_access_time_"
KEY_KEYFRAME_ONLY_PREFIX = "is_key_frame_only_"
FIELD_LAST_QUERY = "last_query"
FIELD_PROXY_RTMP = "proxy_rtmp"
FIELD_STORE = "store"

FRAME_TYPE_NAMES = {0: "", 1: "I", 2: "P", 3: "B"}
FRAME_TYPE_CODES = {v: k for k, v in FRAME_TYPE_NAMES.items()}


def note_publish(backend: str, device_id: str, nbytes: int) -> None:
    """Publish accounting shared by every bus backend: frames and payload
    bytes per (backend, stream)."""
    obs_registry.counter(
        "vep_bus_published_total", "Frames published to the bus",
        ("backend", "stream"),
    ).labels(backend, device_id).inc()
    obs_registry.counter(
        "vep_bus_published_bytes_total", "Frame payload bytes published",
        ("backend", "stream"),
    ).labels(backend, device_id).inc(float(nbytes))


class RingSlotTooSmall(OSError):
    """A frame exceeded its shm ring slot. A type of its own, so that a
    producer can grow the ring and retry without mistaking it for a
    transport error."""


@dataclass
class FrameMeta:
    """Per-frame metadata (the VideoFrame message's fields)."""

    width: int = 0
    height: int = 0
    channels: int = 3
    timestamp_ms: int = 0
    pts: int = 0
    dts: int = 0
    packet: int = 0
    keyframe_cnt: int = 0
    is_keyframe: bool = False
    is_corrupt: bool = False
    frame_type: str = ""
    time_base: float = 0.0
    trace_id: int = 0
    parent_span: int = 0


@dataclass
class Frame:
    seq: int
    data: np.ndarray  # HWC uint8 BGR24
    meta: FrameMeta = field(default_factory=FrameMeta)


class FrameBus(ABC):
    """Abstract frame bus: per-stream latest-wins rings and the control KV."""

    # -- frame plane --

    @abstractmethod
    def create_stream(self, device_id: str, frame_bytes: int, slots: int = 4) -> None:
        """Producer-side: (re)create the ring for a camera."""

    @abstractmethod
    def publish(self, device_id: str, data: np.ndarray, meta: FrameMeta) -> int:
        """Publish one frame; returns its sequence number."""

    @abstractmethod
    def read_latest(self, device_id: str, min_seq: int = 0) -> Optional[Frame]:
        """Newest frame with seq > min_seq, or None. Non-blocking."""

    def read_latest_blocking(self, device_id: str, min_seq: int = 0,
                             timeout_s: float = 1.0) -> Optional[Frame]:
        """Newest frame with seq > min_seq, waiting up to ``timeout_s`` for
        one to arrive; None on timeout. Polls ``read_latest`` every 2 ms,
        which on the shm and memory buses is a couple of loads."""
        deadline = time.monotonic() + timeout_s
        while True:
            frame = self.read_latest(device_id, min_seq=min_seq)
            if frame is not None:
                return frame
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.002)

    def read_latest_into(self, device_id: str, dst: np.ndarray, min_seq: int = 0):
        """Newest frame with seq > min_seq copied INTO ``dst`` (a C-contiguous
        uint8 [H, W, C] view, e.g. one slot of a pooled batch). Returns None
        when there is no new frame; (seq, FrameMeta) after copying into
        ``dst``; or the whole Frame when its geometry does not match ``dst``
        (the caller re-groups with it, nothing is lost).

        The default wraps ``read_latest`` (two memory passes); a backend
        that can copy from its ring straight into ``dst`` overrides it."""
        frame = self.read_latest(device_id, min_seq=min_seq)
        if frame is None:
            return None
        if frame.data.shape != dst.shape or frame.data.dtype != dst.dtype:
            return frame
        np.copyto(dst, frame.data)
        return frame.seq, frame.meta

    @abstractmethod
    def streams(self) -> list:
        """Device ids with a live ring."""

    def head(self, device_id: str) -> Optional[int]:
        """Latest published seq for the stream, or None when unknown. Must
        be cheap (no frame copy): the assembly sweep probes it per planned
        stream per doorbell wake to skip idle rings."""
        return None

    # True when the backend has a cheap publish wake-up: a consumer can
    # block on doorbell_wait instead of sleeping to the tick boundary.
    doorbell = False

    def doorbell_token(self) -> int:
        """Current doorbell value; pass it to doorbell_wait."""
        return 0

    def doorbell_wait(self, token: int, timeout_s: float) -> int:
        """Block until any stream publishes (the doorbell moved past
        ``token``) or ``timeout_s`` elapses; returns the current token.
        Default: a plain sleep, for backends without a doorbell."""
        time.sleep(timeout_s)
        return self.doorbell_token()

    @abstractmethod
    def drop_stream(self, device_id: str) -> None:
        """Producer side: remove the ring (camera stopped)."""

    # -- control plane --

    @abstractmethod
    def kv_set(self, key: str, value: str) -> None: ...

    @abstractmethod
    def kv_get(self, key: str) -> Optional[str]: ...

    @abstractmethod
    def kv_del(self, key: str) -> None: ...

    @abstractmethod
    def kv_keys(self) -> list: ...

    def close(self) -> None:
        pass

    # -- hash-shaped helpers over the KV --
    #
    # A field is the flat key "<key>::<field>", so each hset is one atomic
    # kv_set: concurrent writers of two fields of one hash (touch_query
    # and set_proxy_rtmp) cannot lose each other's update.

    _HASH_FIELDS = (FIELD_LAST_QUERY, FIELD_PROXY_RTMP, FIELD_STORE)

    def hset(self, key: str, field_name: str, value: str) -> None:
        self.kv_set(f"{key}::{field_name}", value)

    def hget(self, key: str, field_name: str) -> Optional[str]:
        return self.kv_get(f"{key}::{field_name}")

    def hgetall(self, key: str) -> dict:
        out: dict = {}
        for field_name in self._HASH_FIELDS:
            val = self.kv_get(f"{key}::{field_name}")
            if val is not None:
                out[field_name] = val
        return out

    def hdel_all(self, key: str) -> None:
        for field_name in self._HASH_FIELDS:
            self.kv_del(f"{key}::{field_name}")

    # -- the control contract --

    def touch_query(self, device_id: str, now_ms: Optional[int] = None) -> None:
        """Record a query of the stream's results (epoch ms, default now):
        it keeps the stream's worker decoding every frame."""
        ts = now_ms if now_ms is not None else int(time.time() * 1000)
        self.hset(KEY_LAST_ACCESS_PREFIX + device_id, FIELD_LAST_QUERY, str(ts))

    def last_query_ms(self, device_id: str) -> Optional[int]:
        val = self.hget(KEY_LAST_ACCESS_PREFIX + device_id, FIELD_LAST_QUERY)
        return int(val) if val else None

    def set_keyframe_only(self, device_id: str, enabled: bool) -> None:
        self.kv_set(KEY_KEYFRAME_ONLY_PREFIX + device_id, "1" if enabled else "0")

    def keyframe_only(self, device_id: str) -> bool:
        return self.kv_get(KEY_KEYFRAME_ONLY_PREFIX + device_id) == "1"

    def set_proxy_rtmp(self, device_id: str, enabled: bool) -> None:
        self.hset(KEY_LAST_ACCESS_PREFIX + device_id, FIELD_PROXY_RTMP,
                  "true" if enabled else "false")

    def proxy_rtmp(self, device_id: str) -> bool:
        return self.hgetall(KEY_LAST_ACCESS_PREFIX + device_id).get(FIELD_PROXY_RTMP) == "true"

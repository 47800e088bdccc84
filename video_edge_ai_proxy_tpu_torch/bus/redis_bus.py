"""Redis-wire-compatible frame bus (counterpart of
``video_edge_ai_proxy_tpu/bus/redis_bus.py``).

A site with reference workers or Redis-reading clients points the port at
the SAME Redis, and everything interoperates, because this backend speaks
the reference's wire contract:

- frame plane: ``XADD <device_id> MAXLEN ~ <n> * data <VideoFrame proto>``
  (producer, ``python/read_image.py:121``); consumers read the newest entry
  and unmarshal field ``data`` as a VideoFrame
  (``server/grpcapi/grpc_api.go:191-229``). A sequence number packs the
  entry id ``<ms>-<n>`` as ``ms << _SEQ_SHIFT | n``, the JAX package's
  packing, so a cursor means the same on either package's bus.
- control plane: hash ``last_access_time_<id>`` with fields
  ``last_query`` (epoch ms) / ``proxy_rtmp`` / ``store`` ("true"/"false"),
  and string key ``is_key_frame_only_<id>`` = "true"/"false"
  (``server/models/RedisConstants.go:18-27``).

Selected by ``bus.backend: redis`` and ``bus.redis_addr``. The shm bus
stays the one-host fast path; this is the interop and scale-out path.
Reads run under a circuit breaker: on a dead link they degrade (no frame,
no streams) instead of raising, and writes raise. Imports the standard
library, numpy and ``google.protobuf`` (the ``VideoFrame`` message), never
torch: a worker process publishes through it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..resilience.breaker import CircuitBreaker
from ..utils.logging import get_logger
from .interface import (
    FIELD_LAST_QUERY,
    KEY_KEYFRAME_ONLY_PREFIX,
    KEY_LAST_ACCESS_PREFIX,
    Frame,
    FrameBus,
    FrameMeta,
    note_publish,
)
from .resp import RespClient, RespError

log = get_logger("bus.redis")

# Stream IDs are "<ms>-<n>"; packed into one int so FrameBus cursors stay
# plain integers. 2^20 sub-ms entries per stream per millisecond is far
# beyond any camera's rate.
_SEQ_SHIFT = 20


def _id_to_seq(entry_id: bytes) -> int:
    ms, _, n = entry_id.decode().partition("-")
    return (int(ms) << _SEQ_SHIFT) | min(int(n or 0), (1 << _SEQ_SHIFT) - 1)


class RedisFrameBus(FrameBus):
    def __init__(self, addr: str = "127.0.0.1:6379", timeout_s: float = 5.0,
                 password: str = "", db: int = 0):
        """``password``/``db`` mirror the reference's RedisSubconfig
        (``config.go:28-35``: connection/database/password) — AUTH and
        SELECT run on every (re)connect so resyncs keep credentials."""
        handshake = []
        if password:
            handshake.append(("AUTH", password))
        if db:
            handshake.append(("SELECT", str(db)))
        self._addr, self._conn_timeout = addr, timeout_s
        self._handshake = tuple(handshake)
        self._client = RespClient.from_addr(addr, timeout_s,
                                            handshake=self._handshake)
        # Blocking XREADs park a socket for up to ~1 s; running them on
        # the SHARED client would head-of-line block every other Redis
        # operation in the process (engine tick, heartbeats, other gRPC
        # handlers) behind its lock. Each waiting thread gets its own
        # lazily-created connection instead — bounded by the gRPC thread
        # pool size, closed with the bus.
        self._block_local = threading.local()
        self._block_clients: list = []
        self._block_clients_lock = threading.Lock()
        self._maxlen: dict[str, int] = {}  # producer-side ring depth
        # streams() verdict cache: key -> (is_frame_stream, probed_at).
        # Accepts are permanent (drop_stream evicts); rejects re-probe
        # after _REPROBE_S so a foreign-looking key that later becomes a
        # real camera is picked up without per-poll payload fetches.
        self._stream_verdict: dict[str, tuple[bool, float]] = {}
        # Read-path circuit breaker: when Redis dies, the engine tick polls
        # every stream every ~10 ms — without a breaker that is hundreds of
        # reconnect storms per second and a raised exception per tick.
        # Open breaker => reads degrade (no frame / no streams) at memory
        # speed; one probe per recovery window re-closes it when the
        # server returns. Writes still raise so producers see the outage.
        self._breaker = CircuitBreaker(
            "redis_bus_read", failure_threshold=3, recovery_timeout_s=1.0
        )

    # -- frame plane --

    def create_stream(self, device_id: str, frame_bytes: int, slots: int = 4) -> None:
        # Ring depth == XADD MAXLEN; frame_bytes is a shm-ring concept with
        # no Redis equivalent (streams size dynamically).
        self._maxlen[device_id] = max(1, slots)
        self._client.command("DEL", device_id)
        # Seed the reference-shaped control hash (grpc_api.go:159-175
        # writes the same key on Query) so streams() can tell OUR empty
        # stream apart from a co-tenant app's stream key without probing
        # payloads. HSETNX: never clobber a live last_query.
        self._client.command(
            "HSETNX", KEY_LAST_ACCESS_PREFIX + device_id, FIELD_LAST_QUERY,
            "0",
        )
        # The FrameBus contract lists a created stream before its first
        # frame (streams()). XGROUP CREATE MKSTREAM materializes an EMPTY
        # stream key atomically — unlike an XADD+XDEL placeholder, no
        # co-reading reference consumer can ever observe a phantom entry
        # (the mixed-fleet case this backend exists for).
        self._client.command(
            "XGROUP", "CREATE", device_id, "_init", "$", "MKSTREAM"
        )
        self._client.command("XGROUP", "DESTROY", device_id, "_init")

    def publish(self, device_id: str, data: np.ndarray, meta: FrameMeta) -> int:
        from ..proto import video_streaming_pb2 as pb

        arr = np.ascontiguousarray(data)
        vf = pb.VideoFrame(
            data=arr.tobytes(),
            width=meta.width or (arr.shape[1] if arr.ndim >= 2 else 0),
            height=meta.height or (arr.shape[0] if arr.ndim >= 2 else 0),
            timestamp=meta.timestamp_ms,
            frame_type=meta.frame_type,
            pts=meta.pts,
            dts=meta.dts,
            packet=meta.packet,
            keyframe=meta.keyframe_cnt,
            time_base=meta.time_base,
            is_keyframe=meta.is_keyframe,
            is_corrupt=meta.is_corrupt,
            trace_id=meta.trace_id,
            parent_span=meta.parent_span,
        )
        for i, dim in enumerate(arr.shape):
            vf.shape.dim.append(pb.ShapeProto.Dim(size=dim, name=str(i)))
        # unsafe_ok: XADD is non-idempotent (a resync retry can append the
        # frame twice), but the frame plane is latest-wins with MAXLEN ~
        # trimming — a duplicate newest entry is benign, losing the frame
        # to a transient flap is worse.
        entry_id = self._client.command(
            "XADD", device_id, "MAXLEN", "~",
            str(self._maxlen.get(device_id, 1)), "*",
            "data", vf.SerializeToString(),
            unsafe_ok=True,
        )
        note_publish("redis", device_id, arr.nbytes)
        return _id_to_seq(entry_id)

    def _guard_read(self, fn, fallback):
        """Run one read under the breaker; degrade to ``fallback`` on a
        dead link (and while the breaker is open) instead of raising."""
        if not self._breaker.allow():
            return fallback
        try:
            out = fn()
        except (OSError, ConnectionError) as exc:
            self._breaker.record_failure()
            log.warning("redis read failed (%s); breaker %s",
                        exc, self._breaker.state)
            return fallback
        self._breaker.record_success()
        return out

    def read_latest(self, device_id: str, min_seq: int = 0) -> Optional[Frame]:
        return self._guard_read(
            lambda: self._read_latest_unguarded(device_id, min_seq), None
        )

    def _read_latest_unguarded(
        self, device_id: str, min_seq: int = 0
    ) -> Optional[Frame]:
        if min_seq:
            # Cheap tip probe before shipping a multi-MB frame body: the
            # collector polls faster than cameras produce, so most reads
            # would fetch a frame only to drop it at the cursor check.
            try:
                info = self._client.command("XINFO", "STREAM", device_id)
            except RespError:
                return None  # no such key
            tip = dict(zip(info[::2], info[1::2])).get(b"last-generated-id")
            if tip is None or _id_to_seq(tip) <= min_seq:
                return None
        reply = self._client.command(
            "XREVRANGE", device_id, "+", "-", "COUNT", "1"
        )
        if not reply:
            return None
        entry_id, fields = reply[0]
        seq = _id_to_seq(entry_id)
        if seq <= min_seq:
            return None
        payload = None
        for k, v in zip(fields[::2], fields[1::2]):
            if k == b"data":
                payload = v
        if payload is None:
            return None
        return Frame(seq=seq, **_unmarshal(payload))

    def read_latest_blocking(
        self, device_id: str, min_seq: int = 0, timeout_s: float = 1.0
    ) -> Optional[Frame]:
        return self._guard_read(
            lambda: self._read_latest_blocking_unguarded(
                device_id, min_seq, timeout_s
            ),
            None,
        )

    def _read_latest_blocking_unguarded(
        self, device_id: str, min_seq: int = 0, timeout_s: float = 1.0
    ) -> Optional[Frame]:
        """Server-side wait via ``XREAD BLOCK`` — ONE round trip per miss
        window where the default poll costs hundreds (reference
        grpc_api.go:191-197 waits the same way, Block=1s).

        XREAD is used purely as a *wake-up*: it returns entries OLDEST-
        first after the cursor, and real Redis's lazy ``MAXLEN ~`` trim
        can leave a deep backlog — serving its reply would hand a
        GetFrame client a seconds-old frame. COUNT 1 bounds the wake-up
        to one body; the actual fetch is ``read_latest``'s newest-wins
        tip read. Each block is
        clamped under the socket timeout (a quiet stream must return a
        clean nil, not a socket error) and re-issued until ``timeout_s``
        is consumed."""
        import time

        last_id = "%d-%d" % (
            min_seq >> _SEQ_SHIFT, min_seq & ((1 << _SEQ_SHIFT) - 1),
        )
        client = self._blocking_client()
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining < 0.002:
                return None
            block_s = min(remaining, max(0.1, client.timeout_s - 1.0))
            # NEVER let the ms value floor to 0: BLOCK 0 means "block
            # forever" in Redis, turning a drained timeout budget into an
            # indefinite server-side hang.
            block_ms = max(1, int(block_s * 1000))
            reply = client.command(
                "XREAD", "COUNT", "1", "BLOCK", str(block_ms),
                "STREAMS", device_id, last_id,
            )
            if reply:
                # Something newer than min_seq exists; serve the tip.
                # Unguarded: this whole loop already runs under ONE
                # breaker admission (a nested allow() would reject the
                # half-open probe's own inner read).
                frame = self._read_latest_unguarded(device_id, min_seq=min_seq)
                if frame is not None:
                    return frame

    def _blocking_client(self) -> RespClient:
        """This thread's dedicated connection for blocking XREADs (see
        __init__ — parking the shared client would head-of-line block
        the whole process)."""
        client = getattr(self._block_local, "client", None)
        if client is None:
            client = RespClient.from_addr(
                self._addr, self._conn_timeout, handshake=self._handshake
            )
            self._block_local.client = client
            with self._block_clients_lock:
                self._block_clients.append(client)
        return client

    _REPROBE_S = 10.0  # rejected-key re-probe interval

    def streams(self) -> list[str]:
        return self._guard_read(self._streams_unguarded, [])

    def _streams_unguarded(self) -> list[str]:
        """Stream-typed keys that are actually camera frame streams.

        The db is shared in the mixed-fleet deployment this backend exists
        for, so a bare ``SCAN TYPE stream`` would report co-tenant apps'
        stream keys as cameras and the engine would unmarshal their
        entries as VideoFrame protos. A key qualifies
        when
        - reference-shaped control keys exist for it
          (``last_access_time_<id>`` / ``is_key_frame_only_<id>`` —
          ``create_stream`` seeds the former, the reference server writes
          it on Query, grpc_api.go:159-175), or
        - its newest entry carries the reference frame contract: a
          ``data`` field parsing as a VideoFrame with pixel payload
          (covers a reference worker XADD-ing before any query).
        Accepts are cached (evicted by drop_stream); rejects re-probe
        every ``_REPROBE_S`` so no per-poll payload traffic goes to
        foreign keys."""
        import time

        now = time.monotonic()
        out = []
        scanned = self._scan_keys("stream")
        for key in scanned:
            verdict = self._stream_verdict.get(key)
            if verdict is None or (
                not verdict[0] and now - verdict[1] > self._REPROBE_S
            ):
                verdict = (self._is_frame_stream(key), now)
                self._stream_verdict[key] = verdict
            if verdict[0]:
                out.append(key)
        # Prune verdicts for keys gone from the db (co-tenant apps churn
        # ephemeral stream names; without this the cache grows for the
        # life of the process).
        if len(self._stream_verdict) > len(scanned):
            keep = set(scanned)
            self._stream_verdict = {
                k: v for k, v in self._stream_verdict.items() if k in keep
            }
        return out

    def _is_frame_stream(self, key: str) -> bool:
        if self._client.command(
            "EXISTS", KEY_LAST_ACCESS_PREFIX + key,
            KEY_KEYFRAME_ONLY_PREFIX + key,
        ):
            return True
        reply = self._client.command("XREVRANGE", key, "+", "-", "COUNT", "1")
        if not reply:
            return False  # empty + no control keys: not one of ours
        _, fields = reply[0]
        payload = dict(zip(fields[::2], fields[1::2])).get(b"data")
        if payload is None:
            return False
        from ..proto import video_streaming_pb2 as pb

        try:
            vf = pb.VideoFrame()
            vf.ParseFromString(payload)
        except Exception:
            return False
        return bool(vf.data) and bool(vf.shape.dim)

    def drop_stream(self, device_id: str) -> None:
        # Also remove the control keys create_stream seeded: an orphaned
        # last_access_time_<id> hash in the shared db would make a future
        # same-named FOREIGN stream key pass _is_frame_stream. The process
        # manager deletes the same keys on its own stop path — this keeps
        # bus-level users (engine-only deployments, tests) equally clean.
        self._client.command(
            "DEL", device_id,
            KEY_LAST_ACCESS_PREFIX + device_id,
            KEY_KEYFRAME_ONLY_PREFIX + device_id,
        )
        self._stream_verdict.pop(device_id, None)

    # -- control plane: plain KV --
    #
    # The cross-backend contract speaks flattened hash fields as
    # "<key>::<field>" (bus/interface.py's helpers); on Redis those live in
    # REAL hashes for reference interop, so the kv_* surface translates:
    # "::"-shaped names route to HGET/HSET/HDEL and kv_keys lists hash
    # fields in flattened form. list-then-get therefore works identically
    # on every backend.

    def kv_set(self, key: str, value: str) -> None:
        if "::" in key:
            base, _, field = key.partition("::")
            self._client.command("HSET", base, field, value)
            return
        self._client.command("SET", key, value)

    def kv_get(self, key: str) -> Optional[str]:
        if "::" in key:
            base, _, field = key.partition("::")
            out = self._client.command("HGET", base, field)
        else:
            out = self._client.command("GET", key)
        return out.decode() if isinstance(out, bytes) else out

    def kv_del(self, key: str) -> None:
        if "::" in key:
            base, _, field = key.partition("::")
            self._client.command("HDEL", base, field)
            return
        self._client.command("DEL", key)

    def kv_keys(self) -> list[str]:
        out = set(self._scan_keys("string"))
        for h in self._scan_keys("hash"):
            fields = self._client.command("HKEYS", h) or []
            out.update(f"{h}::{f.decode()}" for f in fields)
        return sorted(out)

    def _scan_keys(self, want_type: str) -> list[str]:
        # SCAN, never KEYS: this backend shares a production Redis with
        # reference components, and KEYS blocks the whole server. SCAN may
        # return a key on more than one page while the table rehashes, so
        # results dedup through a set.
        out: set[str] = set()
        cursor = b"0"
        while True:
            reply = self._client.command(
                "SCAN", cursor, "COUNT", "1000", "TYPE", want_type
            )
            cursor, keys = reply
            out.update(k.decode() for k in keys)
            if cursor in (b"0", 0, "0"):
                return sorted(out)

    # -- hash helpers: REAL Redis hashes (the shm bus flattens to
    # "<key>::<field>" KV pairs; here wire compatibility requires HSET so
    # reference readers' HGETALL sees the fields, grpc_api.go:166-175 /
    # rtsp_to_rtmp.py:117) --

    def hset(self, key: str, field_name: str, value: str) -> None:
        self._client.command("HSET", key, field_name, value)

    def hget(self, key: str, field_name: str) -> Optional[str]:
        out = self._client.command("HGET", key, field_name)
        return out.decode() if isinstance(out, bytes) else out

    def hgetall(self, key: str) -> dict[str, str]:
        out = self._client.command("HGETALL", key) or []
        return {
            k.decode(): v.decode() for k, v in zip(out[::2], out[1::2])
        }

    def hdel_all(self, key: str) -> None:
        self._client.command("DEL", key)

    # -- keyframe-only flag: reference stores Go strconv.FormatBool text
    # ("true"/"false", grpc_api.go:159-163), and the reference worker
    # compares against "true" (read_image.py:36-45) --

    def set_keyframe_only(self, device_id: str, enabled: bool) -> None:
        self.kv_set(
            KEY_KEYFRAME_ONLY_PREFIX + device_id,
            "true" if enabled else "false",
        )

    def keyframe_only(self, device_id: str) -> bool:
        return self.kv_get(KEY_KEYFRAME_ONLY_PREFIX + device_id) == "true"

    def close(self) -> None:
        self._client.close()
        with self._block_clients_lock:
            for c in self._block_clients:
                try:
                    c.close()
                except Exception:
                    pass
            self._block_clients.clear()


def _unmarshal(payload: bytes) -> dict:
    """VideoFrame proto -> Frame fields (the inverse of publish; same
    reshape the reference's examples do, ``examples/opencv_display.py``)."""
    from ..proto import video_streaming_pb2 as pb

    vf = pb.VideoFrame()
    vf.ParseFromString(payload)
    dims = [d.size for d in vf.shape.dim]
    raw = np.frombuffer(vf.data, dtype=np.uint8)
    if dims and int(np.prod(dims)) == raw.size:
        data = raw.reshape(dims)
    elif vf.height and vf.width and raw.size == vf.height * vf.width * 3:
        data = raw.reshape(vf.height, vf.width, 3)
    else:
        data = raw
    meta = FrameMeta(
        width=vf.width, height=vf.height,
        channels=data.shape[2] if data.ndim == 3 else 1,
        timestamp_ms=vf.timestamp, pts=vf.pts, dts=vf.dts,
        packet=vf.packet, keyframe_cnt=vf.keyframe,
        is_keyframe=vf.is_keyframe, is_corrupt=vf.is_corrupt,
        frame_type=vf.frame_type, time_base=vf.time_base,
        trace_id=vf.trace_id, parent_span=vf.parent_span,
    )
    return {"data": data, "meta": meta}

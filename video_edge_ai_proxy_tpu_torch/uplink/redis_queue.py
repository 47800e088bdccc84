"""Durable Redis-backed annotation queue (counterpart of
``video_edge_ai_proxy_tpu/uplink/redis_queue.py``).

The reference queues annotations in Redis through rmq
(``server/grpcapi/grpc_api.go:69-75``: connection "annotationService",
queue "annotationqueue"), so a server restart mid-outage keeps every
unacked event. The in-memory ``AnnotationQueue`` loses up to
``unacked_limit`` events on a crash; this subclass keeps the same
pipeline in Redis, and the ``Server`` picks it when ``bus.backend:
redis`` (the deployment that has a Redis to be durable in).

The wire layout is rmq's own (github.com/adjust/rmq v4), so a reference
server's rmq consumer on the same Redis can drain the events the port
publishes, and the other way round:

- ready:    ``rmq::queue::[annotationqueue]::ready``        (LPUSH)
- unacked:  ``rmq::connection::<conn>::queue::[annotationqueue]::unacked``
- rejected: ``rmq::queue::[annotationqueue]::rejected``

A delivery moves ready → unacked atomically (RPOPLPUSH), so no instant
exists at which a crash loses it. Recovery is rmq's stale-connection
cleaner, gated on heartbeats: each instance keeps
``rmq::connection::<name>::heartbeat`` (a timestamp), and at startup and
periodically the unacked lists of connections whose heartbeat is stale or
absent go back to ready; a LIVE peer's batch is never taken. The
instance's own connection name is swept at startup unconditionally (it is
that connection's new incarnation; give each instance of a fleet a
``connection`` name of its own).

Counters: ``published``/``acked``/``dropped`` count THIS process's
traffic (monotonic a process); ``depth()`` reads Redis and covers
everything, events left by an earlier incarnation included.
"""

from __future__ import annotations

import time
from typing import Optional

from ..bus.resp import RespClient, RespError
from ..utils.logging import get_logger
from .queue import AnnotationQueue, BatchHandler

log = get_logger("uplink.redis_queue")


class RedisAnnotationQueue(AnnotationQueue):
    def __init__(
        self,
        handler: Optional[BatchHandler] = None,
        *,
        addr: str = "127.0.0.1:6379",
        password: str = "",
        db: int = 0,
        queue_name: str = "annotationqueue",
        connection: str = "vepTpu",
        timeout_s: float = 5.0,
        **kwargs,
    ):
        super().__init__(handler, **kwargs)
        handshake = []
        if password:
            handshake.append(("AUTH", password))
        if db:
            handshake.append(("SELECT", str(db)))
        self._client = RespClient.from_addr(
            addr, timeout_s, handshake=tuple(handshake)
        )
        self._qname = queue_name
        self._conn_name = connection
        self._ready = f"rmq::queue::[{queue_name}]::ready"
        self._rejected_key = f"rmq::queue::[{queue_name}]::rejected"
        self._unacked = (
            f"rmq::connection::{connection}::queue::[{queue_name}]::unacked"
        )
        self._hb_key = f"rmq::connection::{connection}::heartbeat"
        self._other_cached, self._other_at = 0, float("-inf")
        self._last_beat = float("-inf")
        self._last_sweep = time.monotonic()
        self._beat()   # claim our connection before sweeping others
        self.resumed = self._sweep_orphans()
        if self.resumed:
            log.info(
                "recovered %d unacked annotation(s) from a previous run",
                self.resumed,
            )

    # -- crash recovery --

    # A connection whose heartbeat timestamp is older than this (or whose
    # heartbeat key is gone) is considered dead and its unacked deliveries
    # recoverable. Must comfortably exceed the consumer cycle (~300 ms).
    _HEARTBEAT_STALE_S = 30.0

    def _beat(self) -> None:
        """Refresh this connection's liveness marker (~2 s throttle).
        rmq uses a TTL'd heartbeat key; a TIMESTAMP value gives the same
        observable contract (stale/absent = dead) without requiring key
        expiry from the server. Live peers check it before sweeping our
        unacked list (and we check theirs)."""
        now = time.monotonic()
        if now - self._last_beat < 2.0:
            return
        self._last_beat = now
        try:
            self._client.command(
                "SET", self._hb_key, str(int(time.time() * 1000))
            )
        except (RespError, IOError) as exc:
            log.warning("heartbeat write failed: %s", exc)

    def _connection_alive(self, conn: str) -> bool:
        try:
            raw = self._client.command(
                "GET", f"rmq::connection::{conn}::heartbeat"
            )
        except (RespError, IOError):
            return True    # can't tell: never steal a maybe-live batch
        if raw is None:
            return False   # no heartbeat: dead (or pre-heartbeat rmq gone)
        try:
            ts = int(raw)
        except ValueError:
            # rmq's own heartbeat value ("1" with TTL): existence = alive.
            return True
        return time.time() * 1000 - ts < self._HEARTBEAT_STALE_S * 1000

    def _sweep_orphans(self) -> int:
        """Unacked deliveries of DEAD connections back to ready (rmq
        cleaner parity — rmq likewise gates on connection heartbeats, so
        a live peer's mid-POST batch is never stolen into duplicate
        delivery). Our own connection name is swept unconditionally: we
        are its new incarnation (run multi-instance fleets with distinct
        ``connection`` names). Re-delivering a dead connection's events
        is correct because the uplink POST is idempotent on the cloud
        side (same event payload)."""
        n = 0
        try:
            cursor = b"0"
            keys = set()
            # NB: rmq's literal "[queue]" brackets are glob char-classes
            # to MATCH — scan the connection prefix and filter exactly
            # in Python instead of fighting glob escaping.
            suffix = f"::queue::[{self._qname}]::unacked"
            while True:
                reply = self._client.command(
                    "SCAN", cursor, "MATCH", "rmq::connection::*::unacked",
                    "COUNT", "1000",
                )
                cursor, page = reply
                keys.update(
                    k.decode() for k in page if k.decode().endswith(suffix)
                )
                if cursor in (b"0", 0, "0"):
                    break
            for key in keys:
                conn = key.split("::")[2]   # rmq::connection::<name>::…
                if conn != self._conn_name and self._connection_alive(conn):
                    continue
                # `is not None`: RESP nil ends the list; an EMPTY payload
                # (b"", falsy) is a legal queued event and must not halt
                # the sweep with entries still stranded.
                # unsafe_ok: a resync retry can re-run one RPOPLPUSH; the
                # queue's documented contract is duplicates over loss.
                while self._client.command(
                    "RPOPLPUSH", key, self._ready, unsafe_ok=True
                ) is not None:
                    n += 1
        except (RespError, IOError) as exc:
            log.warning("unacked sweep failed (continuing): %s", exc)
        return n

    # -- producer side --

    # unacked+rejected depth is re-read at most this often on the publish
    # path (the consumer cycles every ~300 ms anyway); keeps publish at
    # ONE Redis round trip steady-state instead of four.
    _OTHER_DEPTH_TTL_S = 1.0

    def publish(self, payload: bytes) -> bool:
        try:
            # LPUSH first and use its reply (the ready length) for the
            # limit check — no pre-flight LLENs on the hot path.
            # unsafe_ok on the LPUSH/LPOP pair: a resync retry can
            # duplicate one queued event — tolerated (duplicates over
            # loss; the cloud POST is idempotent on payload).
            ready_len = int(
                self._client.command("LPUSH", self._ready, payload,
                                     unsafe_ok=True)
            )
            if ready_len + self._other_depth() > self._unacked_limit:
                # Over limit: shed from the head — the event just pushed
                # (or a concurrent publisher's, equally being shed).
                self._client.command("LPOP", self._ready, unsafe_ok=True)
                self.dropped += 1
                if self.dropped % 100 == 1:
                    log.warning(
                        "annotation queue full (%d unacked); dropping",
                        self._unacked_limit,
                    )
                return False
            self.published += 1
            return True
        except (RespError, IOError) as exc:
            self.dropped += 1
            log.warning("annotation publish to redis failed: %s", exc)
            return False

    def _other_depth(self) -> int:
        """Cached LLEN(unacked) + LLEN(rejected); ready is always read
        fresh (it is the fast-moving list and LPUSH returns it free)."""
        now = time.monotonic()
        if now - self._other_at > self._OTHER_DEPTH_TTL_S:
            total = 0
            for key in (self._unacked, self._rejected_key):
                total += int(self._client.command("LLEN", key) or 0)
            self._other_cached, self._other_at = total, now
        return self._other_cached

    def depth(self) -> int:
        total = 0
        for key in (self._ready, self._unacked, self._rejected_key):
            out = self._client.command("LLEN", key)
            total += int(out or 0)
        return total

    # -- consumer side --

    def drain_once(self) -> int:
        self._beat()
        batch: list[bytes] = []
        try:
            # Pipelined pop: max_batch RPOPLPUSHes in ONE round trip
            # (command-by-command this is 299 sequential RTTs per batch —
            # slower than the 299/300 ms drain budget on a ~1 ms link).
            # Extra commands past the queue tail return nil, harmlessly.
            # unsafe_ok: a resync retry re-pops into unacked — events land
            # in unacked twice at worst (double delivery, never loss).
            replies = self._client.pipeline([
                ("RPOPLPUSH", self._ready, self._unacked)
            ] * self._max_batch, unsafe_ok=True)
            for v in replies:
                if isinstance(v, (RespError, type(None))):
                    break
                batch.append(v)
        except (RespError, IOError) as exc:
            log.warning("annotation drain pop failed: %s", exc)
        if not batch:
            return 0
        assert self._handler is not None
        try:
            ok = self._handler(batch)
        except Exception as exc:
            log.error("annotation batch handler raised: %s", exc)
            ok = False
        try:
            if ok:
                # unsafe_ok (here and on reject below): double-applied
                # bookkeeping at worst re-delivers, never loses.
                self._client.pipeline([
                    ("LREM", self._unacked, "-1", v) for v in batch
                ], unsafe_ok=True)
                self.acked += len(batch)
                return len(batch)
            self.rejected_batches += 1
            # LPUSH before LREM per event: a crash between the two leaves
            # a DUPLICATE (in rejected + unacked, reconciled to double
            # delivery by the startup sweep — the uplink is idempotent),
            # never a loss. Pipelining preserves this server-side order.
            cmds = []
            for v in batch:
                cmds.append(("LPUSH", self._rejected_key, v))
                cmds.append(("LREM", self._unacked, "-1", v))
            self._client.pipeline(cmds, unsafe_ok=True)
        except (RespError, IOError) as exc:
            # Whatever we couldn't move stays in unacked; the startup
            # sweep of the next incarnation returns it to ready.
            log.warning("annotation ack/reject bookkeeping failed: %s", exc)
        return 0

    def requeue_rejected(self) -> None:
        try:
            # unsafe_ok: duplicates over loss (see drain_once).
            while self._client.command(
                "RPOPLPUSH", self._rejected_key, self._ready, unsafe_ok=True
            ) is not None:
                pass
        except (RespError, IOError) as exc:
            log.warning("annotation requeue failed: %s", exc)
        # Periodic cleaner leg (rmq parity): a connection that dies AFTER
        # our boot becomes sweepable once its heartbeat goes stale.
        now = time.monotonic()
        if now - self._last_sweep > self._HEARTBEAT_STALE_S:
            self._last_sweep = now
            n = self._sweep_orphans()
            if n:
                log.info("cleaner recovered %d unacked annotation(s)", n)

    def stop(self) -> None:
        super().stop()
        try:
            # Clean shutdown: drop the liveness marker so a successor (or
            # a peer's cleaner) can recover anything left immediately
            # instead of waiting out the staleness window.
            self._client.command("DEL", self._hb_key)
        except Exception:
            pass
        try:
            self._client.close()
        except Exception:
            pass

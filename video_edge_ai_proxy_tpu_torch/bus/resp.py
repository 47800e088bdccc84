"""Minimal RESP2 (Redis wire protocol) client (counterpart of
``video_edge_ai_proxy_tpu/bus/resp.py``).

The Redis bus and the Redis annotation queue need a dozen commands, so the
wire protocol is spoken directly, with no client library. RESP2 is small:
a command is an array of bulk strings; replies are simple strings (+),
errors (-), integers (:), bulk strings ($, binary-safe) and arrays (*,
nested). Works against any real Redis server and against the port's
in-process ``miniredis``. Imports the standard library only.
"""

from __future__ import annotations

import socket
import threading
from typing import List, Optional, Union

Reply = Union[None, int, bytes, str, list]


class RespError(Exception):
    """Server returned a RESP error reply."""


#: Verbs that mutate state non-idempotently: re-sending one after a resync
#: can double-apply it (two XADD entries, a counter bumped twice, a list
#: popped twice). Everything else (GET/SET/HSET/DEL/XRANGE/...) converges
#: to the same state when replayed and is safe to auto-retry.
NON_IDEMPOTENT = frozenset({
    b"XADD", b"XDEL", b"XAUTOCLAIM",
    b"INCR", b"INCRBY", b"INCRBYFLOAT", b"DECR", b"DECRBY",
    b"HINCRBY", b"HINCRBYFLOAT",
    b"APPEND", b"SETRANGE",
    b"LPUSH", b"RPUSH", b"LPUSHX", b"RPUSHX", b"LPOP", b"RPOP",
    b"BLPOP", b"BRPOP", b"RPOPLPUSH", b"BRPOPLPUSH", b"LMOVE", b"BLMOVE",
    b"LREM", b"LINSERT", b"SPOP",
})


def _verb(parts) -> bytes:
    head = parts[0]
    if not isinstance(head, bytes):
        head = str(head).encode()
    return head.upper()


class RespClient:
    """One socket, one lock: commands are request/response and the bus
    serializes callers (same stance as the shm bus's consumer lock).

    A socket error mid-command leaves the stream desynced (a partial reply
    may sit in the buffer), so any failure drops the connection, clears the
    buffer, reconnects, and — when that is provably safe — retries the
    command once (the resync the reference gets from go-redis/redis-py's
    connection pools). Safety is idempotency-aware: if ``sendall`` itself
    failed, the server saw at most a partial RESP command it cannot
    execute, so *anything* may be re-sent; if the failure came while
    reading the reply, the command may already have executed, so only
    verbs outside :data:`NON_IDEMPOTENT` are re-sent. A non-idempotent
    command that may have executed surfaces ``ConnectionError`` to the
    caller instead — callers that tolerate duplicates (the XADD frame
    plane under latest-wins, the rmq queue's duplicates-over-loss
    contract) opt back in per call with ``unsafe_ok=True``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout_s: float = 5.0, handshake: tuple = ()):
        """``handshake``: commands (tuples) run on every (re)connect before
        anything else — AUTH / SELECT, so a mid-run resync keeps its
        credentials and database."""
        self._host, self._port = host, port
        self.timeout_s = timeout_s  # public: callers clamp blocking cmds
        self._handshake = tuple(handshake)
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        self._lock = threading.Lock()
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self.timeout_s
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = bytearray()
        try:
            for parts in self._handshake:
                self._sock.sendall(self._encode(parts))
                self._read_reply()  # RespError: bad AUTH must fail loudly
        except BaseException:
            # Never keep a half-initialized (unauthenticated / wrong-db)
            # socket: later commands would reuse it instead of
            # re-handshaking, and a failed constructor would leak the fd.
            self.close()
            raise

    @classmethod
    def from_addr(cls, addr: str, timeout_s: float = 5.0,
                  handshake: tuple = ()) -> "RespClient":
        host, _, port = addr.rpartition(":")
        if not host:  # "host" with no port, or ":6379"
            host, port = (port, "") if not port.isdigit() else ("", port)
        return cls(host or "127.0.0.1", int(port or 6379), timeout_s,
                   handshake=handshake)

    # -- wire --

    # Reads land in one bytearray (amortised appends, consumed from the
    # front), so a multi-megabyte bulk reply, a 1080p frame, costs a few
    # copies and not one per received chunk.
    _RECV = 1 << 20

    def _read_until(self, marker: bytes = b"\r\n") -> bytes:
        start = 0
        while True:
            i = self._buf.find(marker, start)
            if i >= 0:
                break
            start = max(0, len(self._buf) - len(marker) + 1)
            chunk = self._sock.recv(self._RECV)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        line = bytes(self._buf[:i])
        del self._buf[:i + len(marker)]
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            want = min(max(self._RECV, n - len(self._buf)), 4 * self._RECV)
            chunk = self._sock.recv(want)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _read_reply(self) -> Reply:
        line = self._read_until()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"unexpected reply type {line[:1]!r}")

    @staticmethod
    def _encode(parts) -> bytes:
        enc: List[bytes] = []
        for p in parts:
            if isinstance(p, bytes):
                enc.append(p)
            else:
                enc.append(str(p).encode())
        return b"*%d\r\n" % len(enc) + b"".join(
            b"$%d\r\n%s\r\n" % (len(p), p) for p in enc
        )

    def command(self, *parts: Union[str, bytes, int],
                unsafe_ok: bool = False) -> Reply:
        msg = self._encode(parts)
        retry_safe = unsafe_ok or _verb(parts) not in NON_IDEMPOTENT
        with self._lock:
            for attempt in (0, 1):
                sent = False
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(msg)
                    sent = True
                    return self._read_reply()
                except (OSError, ConnectionError):
                    # Desynced or dead link: never reuse the buffer/socket.
                    self.close()
                    # sent=False -> the server got at most a partial RESP
                    # command it cannot execute: replaying is always safe.
                    # sent=True -> it may have executed: replay only
                    # idempotent verbs (or explicit unsafe_ok opt-ins).
                    if attempt or (sent and not retry_safe):
                        raise
            raise ConnectionError("unreachable")  # pragma: no cover

    def pipeline(self, commands, *, unsafe_ok: bool = False) -> list:
        """Send N commands in ONE write and read N replies — one round
        trip instead of N (the batch-drain path needs this: popping and
        acking a 299-event batch command-by-command costs ~600 sequential
        RTTs against a remote server). Resync-retry semantics match
        ``command``, with the whole pipeline as the unit: it is re-sent
        only if the link died before any of it reached the server, or if
        every verb is idempotent, or with ``unsafe_ok=True`` (the
        annotation queue's rmq pipelines opt in — duplicates over loss).

        A server error reply mid-pipeline is returned in place as a
        RespError INSTANCE (not raised): later replies still need
        draining to keep the stream in sync, and callers decide per-slot
        what an error means."""
        if not commands:
            return []
        msg = b"".join(self._encode(c) for c in commands)
        retry_safe = unsafe_ok or all(
            _verb(c) not in NON_IDEMPOTENT for c in commands
        )
        with self._lock:
            for attempt in (0, 1):
                sent = False
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(msg)
                    sent = True
                    out = []
                    for _ in commands:
                        try:
                            out.append(self._read_reply())
                        except RespError as exc:
                            out.append(exc)
                    return out
                except (OSError, ConnectionError):
                    self.close()
                    if attempt or (sent and not retry_safe):
                        raise
            raise ConnectionError("unreachable")  # pragma: no cover

    # -- convenience --

    def command_str(self, *parts) -> Optional[str]:
        out = self.command(*parts)
        return out.decode() if isinstance(out, bytes) else out

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = bytearray()

"""In-process mini Redis server (RESP2); counterpart of
``video_edge_ai_proxy_tpu/bus/miniredis.py``.

The subset of Redis that the bus backend, the annotation queue and the
reference's contract use: strings, hashes, lists and streams with MAXLEN
trimming, served over real sockets, so the RESP client and any reference
tooling speak the actual wire format. Tests and ``chip_smoke.py`` run it
in place of a ``redis-server``; deployments point ``bus.backend: redis``
at a real Redis (the point of wire compatibility).

Approximations against real Redis:
- ``XADD MAXLEN ~`` trims EXACTLY to the bound; real Redis trims lazily
  at node granularity (keeps >= bound entries). Consumers must not rely
  on "exactly maxlen survive": the bus reads newest-first only.
- ``XINFO STREAM`` returns only ``length`` + ``last-generated-id``; the
  real reply has many more fields. The client reads it as a field map,
  so extras are ignored.
- ``SCAN`` paginates with keyset cursors over stable per-key ids (COUNT
  per page, default 10, MATCH/TYPE filtered after paging like real Redis:
  pages may be empty with a non-zero cursor). A key present for the whole
  scan is returned exactly once; keys created or deleted mid-scan may be
  missed, which the contract allows. Cursor values differ from Redis's
  reverse-binary iteration (they are opaque in both).
- RESP2 only: no HELLO/RESP3 push protocol; AUTH is the single-password
  form (no ACL users).
- No expiry (TTL/EXPIRE), no transactions; each command is atomic under
  one dispatch lock.

``python -m video_edge_ai_proxy_tpu_torch.bus.miniredis --port N`` serves
one in a process of its own (it prints its address, then serves until
SIGTERM), so a server under test does not share its interpreter lock.
"""

from __future__ import annotations

import socket
import threading
import time
from fnmatch import fnmatchcase
from typing import Dict, List, Optional, Tuple

StreamEntry = Tuple[Tuple[int, int], List[bytes]]  # ((ms, n), flat fields)


class MiniRedis:
    """``with MiniRedis() as addr: RespClient.from_addr(addr)``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 password: str = ""):
        self._password = password.encode() if password else b""
        self._strings: Dict[bytes, bytes] = {}
        self._hashes: Dict[bytes, Dict[bytes, bytes]] = {}
        self._streams: Dict[bytes, List[StreamEntry]] = {}
        self._last_stream_id: Dict[bytes, Tuple[int, int]] = {}
        self._lists: Dict[bytes, List[bytes]] = {}  # head = index 0
        # SCAN keyset cursors: key -> stable id (see _cmd_scan)
        self._scan_ids: Dict[bytes, int] = {}
        self._next_scan_id = 1
        self._lock = threading.Lock()
        # XADD signals blocked XREADs (Condition over the dispatch lock:
        # cond.wait releases it, so other connections keep serving).
        self._data_arrived = threading.Condition(self._lock)
        self.commands_served = 0   # per-command counter (RTT assertions)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.addr = "%s:%d" % self._srv.getsockname()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="miniredis", daemon=True
        )
        self._accept_thread.start()

    # -- lifecycle --

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def __enter__(self) -> str:
        return self.addr

    def __exit__(self, *_exc) -> None:
        self.close()

    # -- socket plumbing --

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # One bytearray consumed from the front: a 1080p XADD costs a few
        # copies, not one per received chunk.
        buf = bytearray()

        def read_line() -> Optional[bytes]:
            start = 0
            while True:
                i = buf.find(b"\r\n", start)
                if i >= 0:
                    break
                start = max(0, len(buf) - 1)
                chunk = conn.recv(1 << 20)
                if not chunk:
                    return None
                buf.extend(chunk)
            line = bytes(buf[:i])
            del buf[:i + 2]
            return line

        def read_exact(n: int) -> Optional[bytes]:
            while len(buf) < n:
                chunk = conn.recv(min(max(1 << 20, n - len(buf)), 1 << 22))
                if not chunk:
                    return None
                buf.extend(chunk)
            out = bytes(buf[:n])
            del buf[:n]
            return out

        authed = not self._password

        def bad_frame() -> None:
            # Real Redis replies with a protocol error, then closes the
            # connection; it never crashes the serving thread or corrupts
            # other connections (the RESP framing fuzz test drives this).
            try:
                conn.sendall(b"-ERR Protocol error\r\n")
            except OSError:
                pass

        try:
            while not self._stop.is_set():
                line = read_line()
                if line is None:
                    return
                if not line.startswith(b"*") or not line[1:].isdigit():
                    return bad_frame()
                nargs = int(line[1:])
                if nargs > 1_000_000:     # inline bomb: refuse, don't loop
                    return bad_frame()
                parts: List[bytes] = []
                for _ in range(nargs):
                    hdr = read_line()
                    if hdr is None:
                        return
                    if not hdr.startswith(b"$") or not hdr[1:].isdigit():
                        return bad_frame()
                    data = read_exact(int(hdr[1:]))
                    if data is None or read_exact(2) is None:
                        return
                    parts.append(data)
                if not parts:
                    continue      # empty multibulk: ignored, like Redis
                cmd = parts[0].upper()
                # Connection-scoped auth, like Redis requirepass.
                if cmd == b"AUTH":
                    if not self._password:
                        conn.sendall(
                            b"-ERR Client sent AUTH, but no password is set\r\n")
                    elif parts[-1] == self._password:
                        authed = True
                        conn.sendall(b"+OK\r\n")
                    else:
                        conn.sendall(b"-WRONGPASS invalid password\r\n")
                    continue
                if not authed:
                    conn.sendall(b"-NOAUTH Authentication required.\r\n")
                    continue
                conn.sendall(self._dispatch(parts))
        except OSError:
            pass
        finally:
            conn.close()

    # -- RESP encoding --

    @staticmethod
    def _bulk(v: Optional[bytes]) -> bytes:
        if v is None:
            return b"$-1\r\n"
        return b"$%d\r\n%s\r\n" % (len(v), v)

    @classmethod
    def _arr(cls, items: list) -> bytes:
        out = b"*%d\r\n" % len(items)
        for it in items:
            if isinstance(it, list):
                out += cls._arr(it)
            elif isinstance(it, int):
                out += b":%d\r\n" % it
            else:
                out += cls._bulk(it)
        return out

    # -- command dispatch --

    def _dispatch(self, parts: List[bytes]) -> bytes:
        cmd = parts[0].upper().decode()
        fn = getattr(self, f"_cmd_{cmd.lower()}", None)
        if fn is None:
            return f"-ERR unknown command '{cmd}'\r\n".encode()
        with self._lock:
            self.commands_served += 1
            try:
                return fn(parts[1:])
            except Exception as exc:  # malformed args -> RESP error
                return f"-ERR {type(exc).__name__}: {exc}\r\n".encode()

    def _type_of(self, key: bytes) -> str:
        if key in self._streams:
            return "stream"
        if key in self._hashes:
            return "hash"
        if key in self._strings:
            return "string"
        if key in self._lists:
            return "list"
        return "none"

    def _cmd_ping(self, _args):
        return b"+PONG\r\n"

    def _cmd_select(self, args):
        # Single logical db; accept valid indices for connection-string
        # parity (AUTH stays in _serve_conn — it touches connection state).
        if len(args) == 1 and args[0].isdigit() and 0 <= int(args[0]) <= 15:
            return b"+OK\r\n"
        return b"-ERR DB index is out of range\r\n"

    def _cmd_set(self, args):
        self._strings[args[0]] = args[1]
        self._hashes.pop(args[0], None)
        self._streams.pop(args[0], None)
        return b"+OK\r\n"

    def _cmd_get(self, args):
        return self._bulk(self._strings.get(args[0]))

    def _cmd_del(self, args):
        n = 0
        for key in args:
            for table in (self._strings, self._hashes, self._streams,
                          self._lists):
                if key in table:
                    del table[key]
                    n += 1
        return b":%d\r\n" % n

    def _cmd_exists(self, args):
        return b":%d\r\n" % sum(1 for k in args if self._type_of(k) != "none")

    def _cmd_keys(self, args):
        pat = args[0].decode()
        keys = [
            k for k in (*self._strings, *self._hashes, *self._streams,
                        *self._lists)
            if fnmatchcase(k.decode(), pat)
        ]
        return self._arr(sorted(keys))

    def _cmd_scan(self, args):
        # Real cursor pagination . Keyset
        # cursors, not offsets: each key gets a stable id on first sight,
        # the cursor is "resume from id N", and deletions never renumber
        # the survivors — so a concurrent DEL cannot make the scan skip a
        # key that exists throughout (the guarantee real Redis's reverse-
        # binary cursor provides, and the one the unacked-recovery sweep
        # in uplink/redis_queue.py leans on). COUNT bounds the page
        # (default 10, like Redis); MATCH/TYPE filter AFTER paging, so
        # clients see possibly-empty pages with a non-zero cursor.
        if not args[0].isdigit():
            return b"-ERR invalid cursor\r\n"
        cursor = int(args[0])
        match, want_type, count = "*", None, 10
        i = 1
        while i < len(args):
            opt = args[i].upper()
            if opt == b"MATCH":
                match = args[i + 1].decode()
            elif opt == b"TYPE":
                want_type = args[i + 1].decode()
            elif opt == b"COUNT":
                count = int(args[i + 1])
                if count < 1:
                    return b"-ERR syntax error\r\n"
            else:
                return b"-ERR syntax error\r\n"
            i += 2
        live = set(
            (*self._strings, *self._hashes, *self._streams, *self._lists)
        )
        self._scan_ids = {k: v for k, v in self._scan_ids.items()
                          if k in live}
        for k in sorted(live - self._scan_ids.keys()):
            self._scan_ids[k] = self._next_scan_id
            self._next_scan_id += 1
        ordered = sorted(self._scan_ids.items(), key=lambda kv: kv[1])
        window = [(k, v) for k, v in ordered if v >= cursor]
        page, rest = window[:count], window[count:]
        next_cursor = rest[0][1] if rest else 0
        keys = [
            k for k, _ in page
            if fnmatchcase(k.decode(), match)
            and (want_type is None or self._type_of(k) == want_type)
        ]
        return self._arr([b"%d" % next_cursor, keys])

    def _cmd_type(self, args):
        return f"+{self._type_of(args[0])}\r\n".encode()

    def _cmd_hset(self, args):
        h = self._hashes.setdefault(args[0], {})
        added = 0
        for f, v in zip(args[1::2], args[2::2]):
            if f not in h:
                added += 1
            h[f] = v
        return b":%d\r\n" % added

    def _cmd_hsetnx(self, args):
        h = self._hashes.setdefault(args[0], {})
        if args[1] in h:
            return b":0\r\n"
        h[args[1]] = args[2]
        return b":1\r\n"

    def _cmd_hget(self, args):
        return self._bulk(self._hashes.get(args[0], {}).get(args[1]))

    def _cmd_hgetall(self, args):
        flat: list = []
        for f, v in self._hashes.get(args[0], {}).items():
            flat += [f, v]
        return self._arr(flat)

    def _cmd_hkeys(self, args):
        return self._arr(list(self._hashes.get(args[0], {}).keys()))

    def _cmd_xgroup(self, args):
        sub = args[0].upper()
        if sub == b"CREATE":
            key = args[1]
            if key not in self._streams:
                if b"MKSTREAM" not in (a.upper() for a in args):
                    return b"-ERR The XGROUP subcommand requires the key to exist\r\n"
                self._streams[key] = []  # MKSTREAM: empty stream, no entries
            return b"+OK\r\n"
        if sub == b"DESTROY":
            return b":1\r\n"  # groups aren't modeled beyond stream creation
        return b"-ERR unsupported XGROUP subcommand\r\n"

    def _cmd_hdel(self, args):
        h = self._hashes.get(args[0], {})
        n = 0
        for f in args[1:]:
            if f in h:
                del h[f]
                n += 1
        return b":%d\r\n" % n

    def _cmd_xadd(self, args):
        key = args[0]
        i = 1
        maxlen = None
        if args[i].upper() == b"MAXLEN":
            i += 1
            if args[i] in (b"~", b"="):
                i += 1
            maxlen = int(args[i])
            i += 1
        entry_id = args[i]
        i += 1
        fields = list(args[i:])
        now_ms = int(time.time() * 1000)
        if entry_id == b"*":
            last = self._last_stream_id.get(key, (0, -1))
            if now_ms > last[0]:
                new = (now_ms, 0)
            else:  # same ms (or clock went backwards): bump the sub-counter
                new = (last[0], last[1] + 1)
        else:
            ms, _, n = entry_id.partition(b"-")
            new = (int(ms), int(n or 0))
        self._last_stream_id[key] = new
        entries = self._streams.setdefault(key, [])
        entries.append((new, fields))
        if maxlen is not None and len(entries) > maxlen:
            del entries[: len(entries) - maxlen]
        self._data_arrived.notify_all()   # wake blocked XREADs
        return self._bulk(b"%d-%d" % new)

    def _cmd_xread(self, args):
        """XREAD [COUNT n] [BLOCK ms] STREAMS key... id...

        Blocking uses the dispatch-lock Condition: wait releases the
        lock, so other connections keep being served while this one
        blocks (real Redis semantics at this surface). "$" means
        "entries added after this call"."""
        count = block_ms = None
        i = 0
        while i < len(args):
            opt = args[i].upper()
            if opt == b"COUNT":
                count = int(args[i + 1])
                i += 2
            elif opt == b"BLOCK":
                block_ms = int(args[i + 1])
                i += 2
            elif opt == b"STREAMS":
                i += 1
                break
            else:
                return b"-ERR syntax error\r\n"
        rest = args[i:]
        nkeys = len(rest) // 2
        keys, ids = rest[:nkeys], rest[nkeys:]
        after: Dict[bytes, Tuple[int, int]] = {}
        for k, raw in zip(keys, ids):
            if raw == b"$":
                after[k] = self._last_stream_id.get(k, (0, 0))
            else:
                ms, _, n = raw.partition(b"-")
                after[k] = (int(ms), int(n or 0))

        def _collect():
            out = []
            for k in keys:
                found = [e for e in self._streams.get(k, [])
                         if e[0] > after[k]]
                if count is not None:
                    found = found[:count]
                if found:
                    out.append([k, [[b"%d-%d" % eid, fields]
                                    for eid, fields in found]])
            return out

        result = _collect()
        if result or block_ms is None:
            return self._arr(result) if result else b"*-1\r\n"
        # BLOCK 0 = "forever" in Redis; bound it to an hour so a buggy
        # client can never wedge a test process indefinitely.
        deadline = time.monotonic() + (block_ms / 1000.0 if block_ms else 3600)
        while not result:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return b"*-1\r\n"
            self._data_arrived.wait(remaining)
            result = _collect()
        return self._arr(result)

    def _cmd_xlen(self, args):
        return b":%d\r\n" % len(self._streams.get(args[0], []))

    def _cmd_xdel(self, args):
        entries = self._streams.get(args[0], [])
        want = set()
        for raw in args[1:]:
            ms, _, n = raw.partition(b"-")
            want.add((int(ms), int(n or 0)))
        before = len(entries)
        entries[:] = [e for e in entries if e[0] not in want]
        return b":%d\r\n" % (before - len(entries))

    def _cmd_xinfo(self, args):
        if args[0].upper() != b"STREAM":
            return b"-ERR syntax error\r\n"
        key = args[1]
        if key not in self._streams:
            return b"-ERR no such key\r\n"
        last = self._last_stream_id.get(key, (0, 0))
        return self._arr([
            b"length", len(self._streams[key]),
            b"last-generated-id", b"%d-%d" % last,
        ])

    @staticmethod
    def _range_bound(raw: bytes, is_start: bool):
        """One XRANGE/XREVRANGE id bound -> inclusive (ms, n) tuple.
        Supports the sentinels, explicit "ms[-n]" ids (missing seq
        defaults to 0 for a start bound, +inf for an end bound), and the
        exclusive "(id" form (Redis 6.2+) — converted to the adjacent
        inclusive id, so the comparison stays one tuple range check."""
        exclusive = raw.startswith(b"(")
        if exclusive:
            raw = raw[1:]
            if raw in (b"-", b"+"):
                # real Redis: "ERR Invalid stream ID specified"
                raise ValueError("exclusive sentinel bounds are invalid")
        if raw == b"-":
            return (0, 0)
        if raw == b"+":
            return (1 << 63, 1 << 63)
        ms, sep, n = raw.partition(b"-")
        bound = (int(ms), int(n) if sep else (0 if is_start else 1 << 63))
        if exclusive:
            if is_start:        # > bound  ==  >= next id
                bound = (bound[0], bound[1] + 1)
            elif bound[1] > 0:  # < bound  ==  <= previous id
                bound = (bound[0], bound[1] - 1)
            else:
                bound = (bound[0] - 1, 1 << 63)
        return bound

    def _xrange_entries(self, key, lo_raw, hi_raw):
        lo = self._range_bound(lo_raw, True)
        hi = self._range_bound(hi_raw, False)
        return [e for e in self._streams.get(key, []) if lo <= e[0] <= hi]

    def _cmd_xrevrange(self, args):
        # NOTE argument order: XREVRANGE key END START.
        count = None
        if len(args) >= 5 and args[3].upper() == b"COUNT":
            count = int(args[4])
        try:
            entries = list(reversed(
                self._xrange_entries(args[0], args[2], args[1])
            ))
        except ValueError as exc:
            return b"-ERR %s\r\n" % str(exc).encode()
        if count is not None:
            entries = entries[:count]
        return self._arr([
            [b"%d-%d" % eid, fields] for eid, fields in entries
        ])

    def _cmd_xrange(self, args):
        count = None
        if len(args) >= 5 and args[3].upper() == b"COUNT":
            count = int(args[4])
        try:
            entries = self._xrange_entries(args[0], args[1], args[2])
        except ValueError as exc:
            return b"-ERR %s\r\n" % str(exc).encode()
        if count is not None:
            entries = entries[:count]
        return self._arr([
            [b"%d-%d" % eid, fields] for eid, fields in entries
        ])

    # -- lists (the annotation queue's rmq-shaped plane) --

    def _cmd_lpush(self, args):
        lst = self._lists.setdefault(args[0], [])
        for v in args[1:]:
            lst.insert(0, v)
        return b":%d\r\n" % len(lst)

    def _cmd_rpush(self, args):
        lst = self._lists.setdefault(args[0], [])
        lst.extend(args[1:])
        return b":%d\r\n" % len(lst)

    def _cmd_llen(self, args):
        return b":%d\r\n" % len(self._lists.get(args[0], []))

    def _cmd_lrange(self, args):
        lst = self._lists.get(args[0], [])
        start, stop = int(args[1]), int(args[2])
        if start < 0:
            start += len(lst)
        if stop < 0:
            stop += len(lst)
        return self._arr(lst[max(start, 0): stop + 1])

    def _cmd_lpop(self, args):
        lst = self._lists.get(args[0])
        if not lst:
            return b"$-1\r\n"
        v = lst.pop(0)
        if not lst:
            del self._lists[args[0]]
        return self._bulk(v)

    def _cmd_rpop(self, args):
        lst = self._lists.get(args[0])
        if not lst:
            return b"$-1\r\n"
        v = lst.pop()
        if not lst:
            del self._lists[args[0]]
        return self._bulk(v)

    def _cmd_rpoplpush(self, args):
        src = self._lists.get(args[0])
        if not src:
            return b"$-1\r\n"
        v = src.pop()
        if not src:
            del self._lists[args[0]]
        self._lists.setdefault(args[1], []).insert(0, v)
        return self._bulk(v)

    def _cmd_lrem(self, args):
        key, count, value = args[0], int(args[1]), args[2]
        lst = self._lists.get(key, [])
        removed = 0
        if count >= 0:  # head -> tail; 0 = all
            limit = count or len(lst)
            out = []
            for v in lst:
                if v == value and removed < limit:
                    removed += 1
                else:
                    out.append(v)
        else:  # tail -> head, |count| occurrences
            limit = -count
            out = []
            for v in reversed(lst):
                if v == value and removed < limit:
                    removed += 1
                else:
                    out.append(v)
            out.reverse()
        if out:
            self._lists[key] = out
        else:
            self._lists.pop(key, None)
        return b":%d\r\n" % removed

    def _cmd_flushall(self, _args):
        self._strings.clear()
        self._hashes.clear()
        self._streams.clear()
        self._last_stream_id.clear()
        self._lists.clear()
        self._scan_ids.clear()
        return b"+OK\r\n"


def main(argv=None) -> None:
    """Serve one MiniRedis until SIGTERM or SIGINT; prints its address."""
    import argparse
    import signal

    p = argparse.ArgumentParser(description="in-process mini Redis (RESP2)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 picks a free port")
    p.add_argument("--password", default="")
    args = p.parse_args(argv)
    server = MiniRedis(args.host, args.port, password=args.password)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    print(server.addr, flush=True)
    done.wait()
    server.close()


if __name__ == "__main__":
    main()

"""The port's Redis wire (``bus/resp.py``, ``bus/miniredis.py``,
``bus/redis_bus.py``) against the JAX package's.

- Interop both ways: a JAX ``RedisFrameBus`` publishes into the port's
  ``MiniRedis`` and the port's bus reads the same frame, metadata and
  sequence number (``_SEQ_SHIFT`` cursors), and the port publishes into the
  JAX package's ``MiniRedis`` for the JAX bus to read.
- The same calls through either package leave byte-equal Redis state: the
  control-plane keys (``last_access_time_<id>`` hashes,
  ``is_key_frame_only_<id>`` strings, the heartbeat) and the stream
  entries' ``VideoFrame`` bytes.
- The two MiniRedis servers answer one command script with the same bytes.
- The RESP client's retry rule (``unsafe_ok``) and the read breaker on a
  dead link behave as the JAX package's.
- A ``python -m`` worker publishes over Redis for the JAX bus to read, and
  the engine's lockstep folds are the same over the Redis bus as over the
  memory bus.

Tolerance: none; every comparison is exact.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.bus import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus import miniredis as jminiredis
from video_edge_ai_proxy_tpu.bus import redis_bus as jredis_bus
from video_edge_ai_proxy_tpu.bus import resp as jresp
from video_edge_ai_proxy_tpu_torch.bus import FrameMeta, MemoryFrameBus, miniredis, open_bus
from video_edge_ai_proxy_tpu_torch.bus import redis_bus, resp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"port": (miniredis, redis_bus, resp, FrameMeta),
       "jax": (jminiredis, jredis_bus, jresp, JFrameMeta)}


def sample(meta_t, i, h=48, w=64):
    img = np.random.default_rng(i).integers(0, 256, (h, w, 3), dtype=np.uint8)
    meta = meta_t(width=w, height=h, channels=3, timestamp_ms=1000 + i, pts=3000 * i,
                  dts=3000 * i, packet=i, keyframe_cnt=1 + i // 3, is_keyframe=i % 3 == 0,
                  is_corrupt=i == 4, frame_type="I" if i % 3 == 0 else "P",
                  time_base=1 / 90000, trace_id=123456789 + i, parent_span=i)
    return img, meta


@pytest.mark.parametrize("way", ["jax_writes_port_server", "port_writes_jax_server"])
def test_frames_interoperate_both_ways(way):
    writer_pkg, server_pkg = ("jax", "port") if way == "jax_writes_port_server" \
        else ("port", "jax")
    reader_pkg = "port" if writer_pkg == "jax" else "jax"
    with PKG[server_pkg][0].MiniRedis() as addr:
        writer = PKG[writer_pkg][1].RedisFrameBus(addr)
        reader = PKG[reader_pkg][1].RedisFrameBus(addr)
        try:
            writer.create_stream("cam1", 64 * 48 * 3, slots=3)
            assert reader.streams() == ["cam1"]
            assert reader.read_latest("cam1") is None
            sent = []
            for i in range(5):
                img, meta = sample(PKG[writer_pkg][3], i)
                sent.append((writer.publish("cam1", img, meta), img, meta))
            seq, img, meta = sent[-1]
            frame = reader.read_latest("cam1")
            assert frame.seq == seq
            np.testing.assert_array_equal(frame.data, img)
            assert vars(frame.meta) == vars(meta)
            assert reader.read_latest("cam1", min_seq=seq) is None
            # A cursor from one package's bus means the same on the other's.
            assert redis_bus._id_to_seq(b"1700000000123-7") == \
                jredis_bus._id_to_seq(b"1700000000123-7")
            assert redis_bus._SEQ_SHIFT == jredis_bus._SEQ_SHIFT == 20
            dst = np.zeros_like(img)
            got_seq, got_meta = reader.read_latest_into("cam1", dst, min_seq=sent[-2][0])
            assert got_seq == seq and vars(got_meta) == vars(meta)
            np.testing.assert_array_equal(dst, img)
            t = threading.Timer(0.1, lambda: writer.publish("cam1", *sample(
                PKG[writer_pkg][3], 9)))
            t.start()
            woke = reader.read_latest_blocking("cam1", min_seq=seq, timeout_s=3.0)
            t.join()
            assert woke is not None and woke.seq > seq and woke.meta.packet == 9
            writer.touch_query("cam1", now_ms=424242)
            writer.set_keyframe_only("cam1", True)
            writer.set_proxy_rtmp("cam1", True)
            assert reader.last_query_ms("cam1") == 424242
            assert reader.keyframe_only("cam1") and reader.proxy_rtmp("cam1")
            assert sorted(reader.kv_keys()) == sorted(writer.kv_keys())
            writer.drop_stream("cam1")
            assert reader.streams() == []
        finally:
            writer.close()
            reader.close()


def redis_state(addr) -> dict:
    """Every key of a server with its type and value (a stream's entries
    without their time-based ids)."""
    c = resp.RespClient.from_addr(addr)
    try:
        out = {}
        for key in c.command("KEYS", "*"):
            kind = c.command("TYPE", key)
            if kind == "string":
                val = c.command("GET", key)
            elif kind == "hash":
                flat = c.command("HGETALL", key)
                val = sorted(zip(flat[::2], flat[1::2]))
            elif kind == "stream":
                val = [fields for _, fields in c.command("XRANGE", key, "-", "+")]
            else:
                val = c.command("LRANGE", key, "0", "-1")
            out[key] = (kind, val)
        return out
    finally:
        c.close()


def drive(bus, meta_t):
    bus.create_stream("cam7", 6 * 4 * 3, slots=2)
    bus.create_stream("cam8", 6 * 4 * 3, slots=1)
    for i in range(4):
        img, meta = sample(meta_t, i, h=4, w=6)
        bus.publish("cam7", img, meta)
    bus.publish("cam8", *sample(meta_t, 7, h=4, w=6))
    bus.touch_query("cam7", now_ms=1700000000123)
    bus.set_proxy_rtmp("cam7", True)
    bus.set_keyframe_only("cam7", False)
    bus.set_keyframe_only("cam8", True)
    bus.kv_set("stream_status_cam7", '{"pid":1,"running":true}')
    bus.hset("last_access_time_cam8", "store", "true")
    bus.kv_set("last_access_time_cam8::last_query", "5")
    bus.kv_del("last_access_time_cam8::store")
    return sorted(bus.kv_keys()), bus.hgetall("last_access_time_cam7"), bus.streams()


def test_control_plane_keys_and_entries_are_byte_equal():
    states, answers = {}, {}
    for name, (mr, rb, _, meta_t) in PKG.items():
        with miniredis.MiniRedis() as addr:
            bus = rb.RedisFrameBus(addr)
            try:
                answers[name] = drive(bus, meta_t)
            finally:
                bus.close()
            states[name] = redis_state(addr)
    assert answers["port"] == answers["jax"]
    assert states["port"] == states["jax"]
    assert states["port"][b"is_key_frame_only_cam7"] == ("string", b"false")
    assert states["port"][b"is_key_frame_only_cam8"] == ("string", b"true")
    assert dict(states["port"][b"last_access_time_cam7"][1])[b"proxy_rtmp"] == b"true"
    assert len(states["port"][b"cam7"][1]) == 2               # MAXLEN ~ 2
    assert states["port"][b"cam7"][1][0][0] == b"data"


COMMANDS = [
    ("PING",), ("SET", "a", "1"), ("GET", "a"), ("GET", "nope"), ("EXISTS", "a", "b"),
    ("HSET", "h", "f1", "v1", "f2", "v2"), ("HSETNX", "h", "f1", "x"), ("HGET", "h", "f2"),
    ("HGETALL", "h"), ("HKEYS", "h"), ("HDEL", "h", "f1", "zz"), ("TYPE", "h"),
    ("XGROUP", "CREATE", "s", "g", "$", "MKSTREAM"), ("XGROUP", "DESTROY", "s", "g"),
    ("XADD", "s", "MAXLEN", "~", "2", "5-1", "data", "x"),
    ("XADD", "s", "MAXLEN", "~", "2", "5-2", "data", "y"),
    ("XADD", "s", "MAXLEN", "~", "2", "6-0", "data", "z"), ("XLEN", "s"),
    ("XRANGE", "s", "-", "+"), ("XRANGE", "s", "(5-2", "+"), ("XREVRANGE", "s", "+", "-",
                                                              "COUNT", "1"),
    ("XRANGE", "s", "(-", "+"), ("XINFO", "STREAM", "s"), ("XINFO", "STREAM", "nope"),
    ("XREAD", "COUNT", "1", "STREAMS", "s", "5-2"), ("XREAD", "STREAMS", "s", "6-0"),
    ("XDEL", "s", "5-2"), ("LPUSH", "l", "a", "b"), ("RPUSH", "l", "c"), ("LLEN", "l"),
    ("LRANGE", "l", "0", "-1"), ("RPOPLPUSH", "l", "m"), ("LREM", "l", "-1", "a"),
    ("LPOP", "l"), ("RPOP", "m"), ("RPOP", "m"), ("SCAN", "0", "COUNT", "2"),
    ("SCAN", "0", "MATCH", "h*", "COUNT", "100"), ("SCAN", "x"), ("SELECT", "3"),
    ("SELECT", "99"), ("KEYS", "*"), ("DEL", "a", "h", "nope"), ("NOSUCH",), ("FLUSHALL",),
    ("KEYS", "*"),
]


def raw_replies(addr):
    """Each command's reply bytes, as the wire carries them."""
    host, port = addr.rsplit(":", 1)
    out = []
    with socket.create_connection((host, int(port)), timeout=5) as s:
        for cmd in COMMANDS:
            s.sendall(resp.RespClient._encode(cmd))
            time.sleep(0.01)
            s.settimeout(0.2)
            buf = b""
            while True:
                try:
                    chunk = s.recv(65536)
                except socket.timeout:
                    break
                if not chunk:
                    break
                buf += chunk
            out.append(buf)
    return out


def test_miniredis_servers_answer_alike():
    got = {}
    for name, (mr, *_rest) in PKG.items():
        with mr.MiniRedis() as addr:
            got[name] = raw_replies(addr)
    for cmd, a, b in zip(COMMANDS, got["port"], got["jax"]):
        assert a == b, cmd
    assert got["port"][0] == b"+PONG\r\n"


def test_miniredis_auth_alike():
    for name, (mr, rb, rs, _) in PKG.items():
        with mr.MiniRedis(password="s3cret") as addr:
            with pytest.raises(rs.RespError, match="WRONGPASS"):
                rs.RespClient.from_addr(addr, handshake=(("AUTH", "bad"),))
            bus = rb.RedisFrameBus(addr, password="s3cret", db=2)
            bus.kv_set("k", "v")
            assert bus.kv_get("k") == "v", name
            bus.close()


class _OneShot:
    """A server that reads one command per connection and hangs up without
    replying: the reply is lost after the command may have run."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.connections = 0
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.connections += 1
            conn.recv(65536)
            conn.close()

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("cmd,unsafe_ok", [(("XADD", "s", "*", "data", "x"), False),
                                           (("XADD", "s", "*", "data", "x"), True),
                                           (("GET", "k"), False),
                                           (("LPUSH", "q", "e"), False)])
def test_resp_retry_rule_equals_jax(cmd, unsafe_ok):
    """A reply lost after the send: only an idempotent verb, or one the
    caller marks ``unsafe_ok``, is sent again (two connections), in both
    packages."""
    seen = {}
    for name, (_, _, rs, _) in PKG.items():
        srv = _OneShot()
        try:
            client = rs.RespClient.from_addr(srv.addr, timeout_s=2.0)
            with pytest.raises((ConnectionError, OSError)):
                client.command(*cmd, unsafe_ok=unsafe_ok)
            time.sleep(0.05)
            seen[name] = srv.connections
            client.close()
        finally:
            srv.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"] == (2 if unsafe_ok or cmd[0] == "GET" else 1)
    assert resp.NON_IDEMPOTENT == jresp.NON_IDEMPOTENT


def test_pipeline_returns_errors_in_place_alike():
    out = {}
    for name, (mr, _, rs, _) in PKG.items():
        with mr.MiniRedis() as addr:
            c = rs.RespClient.from_addr(addr)
            replies = c.pipeline([("SET", "a", "1"), ("NOSUCH",), ("GET", "a"),
                                  ("LPUSH", "q", "x")], unsafe_ok=True)
            out[name] = [type(r).__name__ if isinstance(r, Exception) else r for r in replies]
            assert c.pipeline([]) == []
            c.close()
    assert out["port"] == out["jax"] == ["OK", "RespError", b"1", 1]


def test_read_breaker_degrades_on_a_dead_link_alike():
    """With the server gone, reads degrade (no frame, no streams) and open
    the breaker after three failures; writes raise. Both packages alike."""
    seen = {}
    for name, (mr, rb, _, meta_t) in PKG.items():
        srv = mr.MiniRedis()
        bus = rb.RedisFrameBus(srv.addr, timeout_s=1.0)
        try:
            bus.create_stream("cam1", 48, slots=2)
            bus.publish("cam1", np.zeros((4, 4, 3), np.uint8), meta_t(timestamp_ms=1))
            assert bus.read_latest("cam1") is not None
            srv.close()
            bus._client.close()
            time.sleep(0.05)
            trail = []
            for _ in range(4):
                trail.append((bus.read_latest("cam1"), bus._breaker.state))
            trail.append((bus.streams(), bus._breaker.state))
            with pytest.raises((ConnectionError, OSError)):
                bus.publish("cam1", np.zeros((4, 4, 3), np.uint8), meta_t(timestamp_ms=2))
            seen[name] = trail
        finally:
            bus.close()
            srv.close()
    assert seen["port"] == seen["jax"]
    assert [f for f, _ in seen["port"][:4]] == [None] * 4 and seen["port"][-1][0] == []
    assert seen["port"][-1][1] == "open"


def test_redis_bus_keeps_the_interface_defaults_for_the_fast_path():
    with miniredis.MiniRedis() as addr:
        bus = open_bus("redis", redis_addr=addr)
        jbus = jredis_bus.RedisFrameBus(addr)
        try:
            bus.create_stream("cam1", 48)
            bus.publish("cam1", np.zeros((4, 4, 3), np.uint8), FrameMeta())
            assert bus.head("cam1") is None and jbus.head("cam1") is None
            assert bus.doorbell is False and jbus.doorbell is False
        finally:
            bus.close()
            jbus.close()


WORKER = """
import sys
from video_edge_ai_proxy_tpu_torch.ingest import worker
worker.main(["--max_frames", "12"])
print(sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax")))
"""


def test_a_worker_publishes_over_redis_for_the_jax_bus():
    with miniredis.MiniRedis() as addr:
        env = dict(os.environ, PYTHONPATH=ROOT, device_id="rcam", vep_bus_backend="redis",
                   vep_redis_addr=addr, in_memory_buffer="2",
                   rtsp_endpoint="test://pattern?w=64&h=48&fps=30&gop=4&pace=0")
        proc = subprocess.run([sys.executable, "-c", WORKER], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.strip().splitlines()[-1] == "[]"
        jbus = jredis_bus.RedisFrameBus(addr)
        try:
            assert jbus.streams() == ["rcam"]
            frame = jbus.read_latest("rcam")
            assert frame.data.shape == (48, 64, 3) and frame.meta.packet == 8   # last keyframe
            hb = jbus.kv_get("stream_status_rcam")
            assert '"source":"synthetic"' in hb and '"packets":12' in hb
        finally:
            jbus.close()


def test_replay_folds_the_same_over_the_redis_bus(tmp_path):
    """Phase 21a's check at a small size on the CPU: ``lockstep_checksum``
    and the engine's ``serve_lockstep`` fold the same integers over a
    RedisFrameBus (the port's MiniRedis) as over the MemoryFrameBus."""
    import torch

    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
    from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
    from video_edge_ai_proxy_tpu_torch.replay.player import TracePlayer
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    path = record_synthetic_trace(str(tmp_path / "t.vtrace"), ["cam0", "cam1", "cam2"],
                                  width=96, height=64, fps=30.0, frames=3)

    def lockstep(bus=None):
        return lockstep_checksum(path, model="tiny_yolov8", device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float32, preprocess_dtype=torch.float32, bus=bus)

    by_packet: dict = {}
    for dev_id, frame, meta in TracePlayer(path).iter_frames():
        by_packet.setdefault(meta.packet, []).append((dev_id, frame, meta))

    def serve(bus):
        engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", dtype="float32"),
                                 device="cpu")
        engine.warmup()
        engine._model.load_state_dict(zero_class_prior(engine._model.state_dict()))
        try:
            return engine.serve_lockstep(by_packet[p] for p in sorted(by_packet)), \
                engine.pipeline_stats().frames
        finally:
            bus.close()

    with miniredis.MiniRedis() as addr:
        rbus = open_bus("redis", redis_addr=addr)
        try:
            got = lockstep(rbus)
            assert rbus.streams() == ["cam0", "cam1", "cam2"]
        finally:
            rbus.close()
        assert got == lockstep() and got["frames"] == 9 and got["checksum"] > 0
        engine_redis = serve(open_bus("redis", redis_addr=addr))
    assert engine_redis == serve(MemoryFrameBus()) and engine_redis[0] > 0 \
        and engine_redis[1] == 9

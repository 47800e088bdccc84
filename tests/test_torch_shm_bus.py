"""The port's frame buses against the JAX package's bus contract.

The contract cases of ``tests/test_bus.py`` (round trip, the single-pass
``read_latest_into`` and its geometry fallback, latest-wins with cursors,
blocking reads, stream listing, the ``head`` probe, the doorbell, the KV
and hash contract, the ring wrap, oversize publishes, the reader's buffer
growth, frames that never alias, the writer's self-heal, a publish from
another process, and the concurrent writer/reader race) run on the port's
``MemoryFrameBus``, ``ShmFrameBus`` and ``RedisFrameBus`` (over the port's
``MiniRedis``) as cases of one parametrised test; the shm-only cases run
on the shm bus alone, and the Redis bus leaves out the ``head`` probe and
the doorbell (it keeps the interface's defaults for both, as the JAX
package's Redis bus does). The interop cases hold the
port's shm bus against the JAX package's on one ring directory: a ring
and KV written by either package are read by the other with the same
bytes, metadata and sequence numbers.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.bus import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus import open_bus as jopen_bus
from video_edge_ai_proxy_tpu_torch.bus import FrameMeta, MemoryFrameBus, open_bus
from video_edge_ai_proxy_tpu_torch.bus.interface import Frame
from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ShmFrameBus, ring_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {}
SHM_ONLY = set()


def case(shm_only=False):
    def register(fn):
        CASES[fn.__name__] = fn
        if shm_only:
            SHM_ONLY.add(fn.__name__)
        return fn
    return register


@case()
def publish_read_roundtrip(prod, cons, shm_dir):
    prod.create_stream("cam1", 64 * 48 * 3)
    img = np.arange(64 * 48 * 3, dtype=np.uint8).reshape(48, 64, 3)
    meta = FrameMeta(timestamp_ms=42, pts=7, is_keyframe=True, frame_type="I", packet=3,
                     keyframe_cnt=1)
    seq = prod.publish("cam1", img, meta)
    frame = cons.read_latest("cam1")
    assert frame is not None and frame.seq == seq
    np.testing.assert_array_equal(frame.data, img)
    assert frame.meta.timestamp_ms == 42
    assert frame.meta.is_keyframe and frame.meta.frame_type == "I"
    assert frame.meta.packet == 3


@case()
def read_latest_into_single_pass(prod, cons, shm_dir):
    prod.create_stream("cam1", 32 * 24 * 3)
    img = np.arange(32 * 24 * 3, dtype=np.uint8).reshape(24, 32, 3)
    seq = prod.publish("cam1", img, FrameMeta(width=32, height=24, channels=3, timestamp_ms=5))
    dst = np.zeros((24, 32, 3), np.uint8)
    res = cons.read_latest_into("cam1", dst)
    assert isinstance(res, tuple)
    got_seq, meta = res
    assert got_seq == seq and meta.timestamp_ms == 5
    np.testing.assert_array_equal(dst, img)
    assert cons.read_latest_into("cam1", dst, min_seq=got_seq) is None


@case()
def read_latest_into_geometry_mismatch_falls_back(prod, cons, shm_dir):
    prod.create_stream("cam1", 32 * 24 * 3)
    img = np.full((24, 32, 3), 9, np.uint8)
    prod.publish("cam1", img, FrameMeta(width=32, height=24, channels=3))
    res = cons.read_latest_into("cam1", np.zeros((48, 64, 3), np.uint8))
    assert isinstance(res, Frame)
    np.testing.assert_array_equal(res.data, img)
    res2 = cons.read_latest_into("cam1", np.zeros((12, 16, 3), np.uint8), min_seq=0)
    assert isinstance(res2, Frame)
    np.testing.assert_array_equal(res2.data, img)


@case()
def latest_wins_and_cursor(prod, cons, shm_dir):
    prod.create_stream("cam1", 1024)
    img = np.zeros((4, 4, 3), dtype=np.uint8)
    for i in range(10):
        prod.publish("cam1", img, FrameMeta(timestamp_ms=i))
    f = cons.read_latest("cam1")
    assert f.meta.timestamp_ms == 9
    assert cons.read_latest("cam1", min_seq=f.seq) is None
    prod.publish("cam1", img, FrameMeta(timestamp_ms=99))
    assert cons.read_latest("cam1", min_seq=f.seq).meta.timestamp_ms == 99


@case()
def missing_stream(prod, cons, shm_dir):
    assert cons.read_latest("ghost") is None


@case()
def blocking_read_default_poll(prod, cons, shm_dir):
    prod.create_stream("cam1", 1024)
    img = np.zeros((4, 4, 3), dtype=np.uint8)
    t = threading.Timer(0.1, lambda: prod.publish("cam1", img, FrameMeta(timestamp_ms=5)))
    t.start()
    frame = cons.read_latest_blocking("cam1", timeout_s=2.0)
    t.join()
    assert frame is not None and frame.meta.timestamp_ms == 5
    t0 = time.monotonic()
    assert cons.read_latest_blocking("cam1", min_seq=frame.seq, timeout_s=0.15) is None
    assert time.monotonic() - t0 < 1.0


@case()
def streams_and_drop(prod, cons, shm_dir):
    prod.create_stream("a", 64)
    prod.create_stream("b", 64)
    assert cons.streams() == ["a", "b"]
    prod.drop_stream("a")
    assert cons.streams() == ["b"]


@case()
def head_probe(prod, cons, shm_dir):
    prod.create_stream("cam1", 16 * 16 * 3)
    assert cons.head("cam1") in (None, 0)
    seq = prod.publish("cam1", np.zeros((16, 16, 3), np.uint8), FrameMeta(timestamp_ms=1))
    assert cons.head("cam1") == seq


@case()
def doorbell_contract(prod, cons, shm_dir):
    prod.create_stream("cam1", 16 * 16 * 3)
    tok = cons.doorbell_token()
    t0 = time.monotonic()
    cons.doorbell_wait(tok, 0.05)            # idle: about the full timeout
    assert time.monotonic() - t0 >= 0.04
    assert cons.doorbell
    woke = []

    def waiter():
        t = cons.doorbell_token()
        woke.append((cons.doorbell_wait(t, 2.0), time.monotonic()))

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    t_pub = time.monotonic()
    prod.publish("cam1", np.zeros((16, 16, 3), np.uint8), FrameMeta(timestamp_ms=2))
    th.join(timeout=2)
    assert woke, "doorbell waiter never woke"
    new_tok, t_wake = woke[0]
    assert new_tok != tok
    assert t_wake - t_pub < 0.5              # woke on the publish, not the timeout


@case()
def kv_contract(prod, cons, shm_dir):
    prod.touch_query("cam1", now_ms=1234)
    assert cons.last_query_ms("cam1") == 1234
    prod.set_keyframe_only("cam1", True)
    assert cons.keyframe_only("cam1")
    prod.set_keyframe_only("cam1", False)
    assert not cons.keyframe_only("cam1")
    prod.set_proxy_rtmp("cam1", True)
    assert cons.proxy_rtmp("cam1")
    assert any(k.startswith("last_access_time_cam1") for k in cons.kv_keys())
    prod.hdel_all("last_access_time_cam1")
    assert cons.last_query_ms("cam1") is None


@case()
def hash_fields_coexist(prod, cons, shm_dir):
    prod.touch_query("cam1", now_ms=5)
    prod.set_proxy_rtmp("cam1", True)
    h = cons.hgetall("last_access_time_cam1")
    assert h["last_query"] == "5" and h["proxy_rtmp"] == "true"


@case()
def concurrent_writer_reader_never_tears(prod, cons, shm_dir):
    """A writer publishes frames whose every byte is i % 251 (and i as the
    timestamp) while two readers read the newest as fast as they can: a
    read with mixed bytes, or bytes that do not match its meta, is torn."""
    h = w = 64
    prod.create_stream("race", h * w * 3)
    stop = threading.Event()
    torn, reader_errors = [], []
    published = {"n": 0}

    def writer():
        i = 0
        while not stop.is_set():
            prod.publish("race", np.full((h, w, 3), i % 251, np.uint8),
                         FrameMeta(width=w, height=h, channels=3, timestamp_ms=i,
                                   is_keyframe=True))
            published["n"] = i = i + 1

    def reader():
        cursor = 0
        try:
            while not stop.is_set():
                got = cons.read_latest("race", min_seq=cursor)
                if got is None:
                    continue
                cursor = got.seq
                u = np.unique(got.data)
                if len(u) != 1:
                    torn.append(sorted(int(v) for v in u))
                    return
                if int(got.data.flat[0]) != got.meta.timestamp_ms % 251:
                    torn.append([int(got.data.flat[0]), "vs_ts", got.meta.timestamp_ms])
                    return
        except Exception as exc:
            reader_errors.append(repr(exc))

    threads = [threading.Thread(target=writer, daemon=True),
               threading.Thread(target=reader, daemon=True),
               threading.Thread(target=reader, daemon=True)]
    for t in threads:
        t.start()
    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not reader_errors, f"reader crashed: {reader_errors[0]}"
    assert not torn, f"torn frame observed: {torn[0]}"
    assert published["n"] > 100, "writer barely ran; the test proves nothing"


@case()
def read_into_pooled_slot_never_tears(prod, cons, shm_dir):
    """The collector's fast path: ``read_latest_into`` straight into a
    slot of a batch buffer under a concurrent writer is never torn."""
    h = w = 64
    prod.create_stream("race", h * w * 3)
    stop = threading.Event()
    torn, reads = [], {"n": 0}

    def writer():
        i = 0
        while not stop.is_set():
            prod.publish("race", np.full((h, w, 3), i % 251, np.uint8),
                         FrameMeta(width=w, height=h, channels=3, timestamp_ms=i))
            i += 1

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    batch = np.zeros((4, h, w, 3), np.uint8)
    cursor = 0
    deadline = time.monotonic() + 1.5
    while time.monotonic() < deadline and not torn:
        res = cons.read_latest_into("race", batch[reads["n"] % 4], min_seq=cursor)
        if res is None:
            continue
        cursor, meta = res
        slot = batch[reads["n"] % 4]
        if len(np.unique(slot)) != 1 or int(slot.flat[0]) != meta.timestamp_ms % 251:
            torn.append(meta.timestamp_ms)
        reads["n"] += 1
    stop.set()
    th.join(timeout=10)
    assert not torn, f"torn read into a pooled slot at timestamp {torn[0]}"
    assert reads["n"] > 20


@case(shm_only=True)
def cross_process_publish(prod, cons, shm_dir):
    """A second process publishes; this one reads: the worker -> engine
    topology."""
    code = textwrap.dedent(f"""
        import numpy as np
        from video_edge_ai_proxy_tpu_torch.bus import open_bus, FrameMeta
        bus = open_bus("shm", {shm_dir!r})
        bus.create_stream("pcam", 32*32*3)
        bus.publish("pcam", np.full((32, 32, 3), 7, dtype=np.uint8), FrameMeta(timestamp_ms=777))
        bus.kv_set("hello", "from-child")
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    frame = cons.read_latest("pcam")
    assert frame is not None and frame.meta.timestamp_ms == 777
    assert frame.data.shape == (32, 32, 3) and (frame.data == 7).all()
    assert cons.kv_get("hello") == "from-child"


@case(shm_only=True)
def ring_wrap_consistency(prod, cons, shm_dir):
    prod.create_stream("cam", 1000, slots=2)
    for i in range(50):
        prod.publish("cam", np.full((10, 10, 3), i % 256, dtype=np.uint8),
                     FrameMeta(timestamp_ms=i))
        f = cons.read_latest("cam")
        assert f is not None
        assert (f.data == f.meta.timestamp_ms % 256).all()


@case(shm_only=True)
def oversize_publish_rejected(prod, cons, shm_dir):
    prod.create_stream("cam", 100)
    with pytest.raises(OSError):
        prod.publish("cam", np.zeros((100, 100, 3), np.uint8), FrameMeta())


@case(shm_only=True)
def large_frame_grows_reader_buffer(prod, cons, shm_dir):
    cons._buf = np.empty(16, dtype=np.uint8)  # force the regrow path
    prod.create_stream("cam", 1920 * 1080 * 3)
    img = np.random.default_rng(0).integers(0, 255, (1080, 1920, 3), dtype=np.uint8)
    prod.publish("cam", img, FrameMeta())
    np.testing.assert_array_equal(cons.read_latest("cam").data, img)


@case(shm_only=True)
def fast_path_frames_never_alias(prod, cons, shm_dir):
    prod.create_stream("cam", 32 * 32 * 3)
    frames, seq = [], 0
    for v in (1, 2, 3):
        prod.publish("cam", np.full((32, 32, 3), v, dtype=np.uint8), FrameMeta(timestamp_ms=v))
        f = cons.read_latest("cam", min_seq=seq)
        seq = f.seq
        frames.append(f)
        assert cons.read_latest("cam", min_seq=seq) is None
    for v, f in zip((1, 2, 3), frames):
        assert (f.data == v).all()
    assert len({id(f.data.base if f.data.base is not None else f.data) for f in frames}) == 3


@case(shm_only=True)
def writer_self_heals_replaced_ring_file(prod, cons, shm_dir):
    prod.create_stream("cam", 32 * 32 * 3)
    img = np.full((32, 32, 3), 1, dtype=np.uint8)
    prod.publish("cam", img, FrameMeta(timestamp_ms=1))
    assert cons.read_latest("cam").meta.timestamp_ms == 1
    os.unlink(os.path.join(shm_dir, "cam.ring"))
    time.sleep(prod._REVALIDATE_S + 0.05)
    prod.publish("cam", img, FrameMeta(timestamp_ms=2))
    time.sleep(cons._REVALIDATE_S + 0.05)
    f = cons.read_latest("cam")
    assert f is not None and f.meta.timestamp_ms == 2


@case(shm_only=True)
def ring_file_size(prod, cons, shm_dir):
    """The ring file is ``ring_bytes`` long (the room a directory needs
    for it), payloads rounded up to 64 bytes."""
    for name, frame_bytes, slots in (("cam", 1920 * 1080 * 3, 2), ("odd", 1001, 3)):
        prod.create_stream(name, frame_bytes, slots=slots)
        assert (os.path.getsize(os.path.join(shm_dir, name + ".ring"))
                == ring_bytes(frame_bytes, slots))
    assert ring_bytes(1001, 3) - ring_bytes(1001, 2) == ring_bytes(1024, 3) - ring_bytes(1024, 2)


# The fast-path probes the Redis bus does not offer (head: None; doorbell:
# off), as in the JAX package.
NOT_REDIS = {"head_probe", "doorbell_contract"}
PARAMS = [(backend, name) for name in CASES for backend in ("memory", "shm", "redis")
          if backend == "shm" or (name not in SHM_ONLY
                                  and (backend == "memory" or name not in NOT_REDIS))]


@pytest.mark.parametrize("backend,name", PARAMS, ids=[f"{b}-{n}" for b, n in PARAMS])
def test_bus_contract(backend, name, shm_dir):
    server = None
    if backend == "memory":
        prod = cons = MemoryFrameBus()
    elif backend == "redis":
        from video_edge_ai_proxy_tpu_torch.bus.miniredis import MiniRedis
        from video_edge_ai_proxy_tpu_torch.bus.redis_bus import RedisFrameBus

        server = MiniRedis()
        prod, cons = open_bus("redis", redis_addr=server.addr), \
            open_bus("redis", redis_addr=server.addr)
        assert isinstance(prod, RedisFrameBus)
    else:
        prod, cons = open_bus("shm", shm_dir), open_bus("shm", shm_dir)
        assert isinstance(prod, ShmFrameBus)
    try:
        CASES[name](prod, cons, shm_dir)
    finally:
        prod.close()
        cons.close()
        if server is not None:
            server.close()


# -- interop with the JAX package's shm bus -------------------------------------


def _pairs(shm_dir):
    """(writer, reader, reader's FrameMeta type) both ways round."""
    return {"jax_writes": (jopen_bus("shm", shm_dir), open_bus("shm", shm_dir), JFrameMeta),
            "port_writes": (open_bus("shm", shm_dir), jopen_bus("shm", shm_dir), FrameMeta)}


@pytest.mark.parametrize("way", ["jax_writes", "port_writes"])
def test_rings_and_kv_cross_read(way, shm_dir):
    writer, reader, meta_t = _pairs(shm_dir)[way]
    rng = np.random.default_rng(5)
    try:
        writer.create_stream("cam1", 96 * 128 * 3, slots=3)
        sent = []
        for i in range(5):
            img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
            meta = meta_t(width=128, height=96, channels=3, timestamp_ms=1000 + i, pts=3000 * i,
                          dts=3000 * i, packet=i, keyframe_cnt=1 + i // 3, is_keyframe=i % 3 == 0,
                          is_corrupt=i == 4, frame_type="I" if i % 3 == 0 else "P",
                          time_base=1 / 90000, trace_id=123456789 + i, parent_span=i)
            sent.append((writer.publish("cam1", img, meta), img, meta))
        assert reader.streams() == ["cam1"] and reader.head("cam1") == sent[-1][0]
        seq, img, meta = sent[-1]
        frame = reader.read_latest("cam1")
        assert frame.seq == seq
        np.testing.assert_array_equal(frame.data, img)
        assert vars(frame.meta) == vars(meta)
        dst = np.zeros_like(img)
        got_seq, got_meta = reader.read_latest_into("cam1", dst, min_seq=seq - 1)
        assert got_seq == seq and vars(got_meta) == vars(meta)
        np.testing.assert_array_equal(dst, img)
        assert reader.read_latest("cam1", min_seq=seq) is None
        # The control KV and the doorbell are shared too.
        writer.touch_query("cam1", now_ms=424242)
        writer.set_keyframe_only("cam1", True)
        assert reader.last_query_ms("cam1") == 424242 and reader.keyframe_only("cam1")
        assert sorted(reader.kv_keys()) == sorted(writer.kv_keys())
        tok = reader.doorbell_token()
        writer.publish("cam1", img, meta)
        assert reader.doorbell_wait(tok, 2.0) != tok
    finally:
        writer.close()
        reader.close()


def test_open_bus_backends(shm_dir):
    assert isinstance(open_bus("memory"), MemoryFrameBus)
    bus = open_bus("shm", shm_dir)
    assert isinstance(bus, ShmFrameBus)
    bus.close()
    from video_edge_ai_proxy_tpu_torch.bus.miniredis import MiniRedis
    from video_edge_ai_proxy_tpu_torch.bus.redis_bus import RedisFrameBus

    with MiniRedis() as addr:
        bus = open_bus("redis", redis_addr=addr)
        assert isinstance(bus, RedisFrameBus)
        bus.close()
    with pytest.raises(ValueError, match="unknown bus backend"):
        open_bus("kafka")


def test_replay_folds_the_same_over_the_shm_bus(tmp_path, shm_dir):
    """Phase 13a's check at a small size on the CPU: ``lockstep_checksum``
    and the engine's ``serve_lockstep`` fold the same integers over a
    ShmFrameBus as over the MemoryFrameBus."""
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

    shm = ShmFrameBus(os.path.join(shm_dir, "lockstep"))
    try:
        got = lockstep(shm)
        assert shm.streams() == ["cam0", "cam1", "cam2"]   # the bus was used, left open
    finally:
        shm.close()
    assert got == lockstep() and got["frames"] == 9 and got["checksum"] > 0

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

    engine_shm = serve(ShmFrameBus(os.path.join(shm_dir, "engine")))
    assert engine_shm == serve(MemoryFrameBus()) and engine_shm[0] > 0 and engine_shm[1] == 9

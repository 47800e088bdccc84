"""The port's ingest worker against the JAX package's.

- The reference's worker cases (``tests/test_ingest.py``): the synthetic
  source, the decode gate in its four states (idle, a fresh query,
  keyframe-only over a query, a stale query), frames on the bus and the
  status heartbeat, on the port's worker.
- The same ``test://`` (and ``replay://``) URL through both packages'
  workers publishes byte-identical frames with equal ``FrameMeta``,
  timestamps aside; both flight recorders (``trace_dir``) write the same
  events; ``parse_fresh_status`` agrees on the same heartbeats.
- A worker started as ``python -m video_edge_ai_proxy_tpu_torch.ingest.worker``
  with the environment contract publishes onto a shm ring directory, and
  the port's engine serves its frames on the CPU (``tiny_yolov8``), keeping
  the worker decoding every frame while a subscriber reads; SIGTERM ends
  the worker with exit code 0.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.ingest import IngestWorker as JIngestWorker
from video_edge_ai_proxy_tpu.ingest import WorkerConfig as JWorkerConfig
from video_edge_ai_proxy_tpu.ingest.worker import parse_fresh_status as jparse_fresh_status
from video_edge_ai_proxy_tpu_torch.bus import MemoryFrameBus, open_bus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.ingest import (
    IngestWorker, SyntheticSource, WorkerConfig, open_source,
)
from video_edge_ai_proxy_tpu_torch.ingest.worker import (
    KEY_STATUS_PREFIX, STATUS_FRESH_MS, parse_fresh_status,
)
from video_edge_ai_proxy_tpu_torch.replay.player import ReplaySource
from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def unpaced(url_extra: str = "") -> str:
    return "test://pattern?w=64&h=48&fps=30&gop=5&pace=0" + url_extra


def test_synthetic_source_grab_retrieve():
    src = open_source(unpaced("&frames=12"))
    assert isinstance(src, SyntheticSource)
    src.open()
    packets, frames = [], []
    while (pkt := src.grab()) is not None:
        packets.append(pkt)
        frames.append(src.retrieve())
    assert len(packets) == 12
    assert [p.is_keyframe for p in packets[:6]] == [True, False, False, False, False, True]
    assert frames[0].shape == (48, 64, 3) and frames[0].dtype == np.uint8
    assert not np.array_equal(frames[0], frames[1])


def test_synthetic_source_pts_monotonic():
    src = SyntheticSource(unpaced("&frames=5"))
    src.open()
    pts = [src.grab().pts for _ in range(5)]
    assert pts == sorted(pts) and len(set(pts)) == 5


def test_sources_the_port_does_not_open_raise():
    """Camera URLs, the archive and the RTMP pass-through, which earlier
    slices refused, now open: a camera URL routes to the libav source (or
    to OpenCV where the shim cannot build, as the JAX package routes it),
    and a worker with ``disk_buffer_path`` or ``rtmp_endpoint`` builds."""
    from video_edge_ai_proxy_tpu_torch.ingest import av
    from video_edge_ai_proxy_tpu_torch.ingest.sources import OpenCVSource, PacketSource

    src = open_source("rtsp://camera.local/stream")
    assert isinstance(src, PacketSource if av.available() else OpenCVSource)
    assert src.kind == ("packet" if av.available() else "opencv")
    for side in ({"disk_buffer_path": "/archive"}, {"rtmp_endpoint": "rtmp://relay/live"}):
        worker = IngestWorker(WorkerConfig(rtsp_endpoint=unpaced(), device_id="cam1", **side),
                              bus=MemoryFrameBus())
        assert worker.cfg.disk_buffer_path == side.get("disk_buffer_path", "")
        assert worker.cfg.rtmp_endpoint == side.get("rtmp_endpoint", "")


def _run_worker(bus, worker_cls=IngestWorker, cfg_cls=WorkerConfig, *, url=None, frames=20,
                query=False, keyframe_only=False, stale_query=False):
    cfg = cfg_cls(rtsp_endpoint=url or unpaced(f"&frames={frames}"), device_id="cam1",
                  bus_backend="memory", max_frames=frames)
    worker = worker_cls(cfg, bus=bus)
    if query:
        bus.touch_query("cam1")
    if stale_query:
        bus.touch_query("cam1", now_ms=int(time.time() * 1000) - 60_000)
    if keyframe_only:
        bus.set_keyframe_only("cam1", True)
    worker.run()
    return worker


GATE_STATES = {
    # (bus setup, frames decoded of 20 at gop 5): keyframes always; the
    # rest only under a fresh query; keyframe-only mode wins over a query.
    "idle": ({}, 4),
    "fresh_query": ({"query": True}, 20),
    "keyframe_only_wins_over_query": ({"query": True, "keyframe_only": True}, 4),
    "stale_query": ({"stale_query": True}, 4),
}


@pytest.mark.parametrize("state", list(GATE_STATES))
def test_decode_gate(state):
    setup, decoded = GATE_STATES[state]
    w = _run_worker(MemoryFrameBus(), **setup)
    jw = _run_worker(JMemoryFrameBus(), JIngestWorker, JWorkerConfig, **setup)
    assert w._keyframes == 4
    assert w._decoded == w._published == decoded
    assert (w._packets, w._keyframes, w._decoded, w._published) == (
        jw._packets, jw._keyframes, jw._decoded, jw._published)


def test_published_frames_on_bus():
    bus = MemoryFrameBus()
    _run_worker(bus, frames=20, query=True)
    frame = bus.read_latest("cam1")
    assert frame is not None
    assert frame.data.shape == (48, 64, 3)
    assert frame.meta.packet == 19


def test_status_heartbeat():
    bus = MemoryFrameBus()
    _run_worker(bus, frames=20)
    hb = json.loads(bus.kv_get(KEY_STATUS_PREFIX + "cam1"))
    assert hb["packets"] == 20 and hb["pid"] > 0
    assert hb["keyframes"] == hb["decoded"] == hb["published"] == 4
    assert hb["source"] == "synthetic"


def _recording(base):
    """``base`` bus class that also keeps every publish (frame, meta)."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.log = []

        def publish(self, device_id, data, meta):
            self.log.append((device_id, np.array(data, copy=True), dataclasses.asdict(meta)))
            return super().publish(device_id, data, meta)
    return Recording


def _same_publishes(got, want):
    assert len(got) == len(want) > 0
    for (d, frame, meta), (jd, jframe, jmeta) in zip(got, want):
        assert d == jd
        np.testing.assert_array_equal(frame, jframe)
        meta.pop("timestamp_ms")
        jmeta.pop("timestamp_ms")
        assert meta == jmeta


@pytest.mark.parametrize("query", [False, True], ids=["keyframes_only", "every_frame"])
def test_same_url_publishes_the_same_frames_as_jax(query):
    url = "test://pattern?w=96&h=64&fps=30&gop=4&pace=0&frames=13"
    bus, jbus = _recording(MemoryFrameBus)(), _recording(JMemoryFrameBus)()
    _run_worker(bus, url=url, frames=13, query=query)
    _run_worker(jbus, JIngestWorker, JWorkerConfig, url=url, frames=13, query=query)
    assert len(bus.log) == (13 if query else 4)
    _same_publishes(bus.log, jbus.log)


def test_replay_url_publishes_the_same_frames_as_jax(tmp_path):
    path = record_synthetic_trace(str(tmp_path / "two.vtrace"), ["cam1", "cam2"], width=80,
                                  height=48, fps=30.0, frames=6, gop=3)
    url = f"replay://{path}?device=cam2&pace=0"
    src = open_source(url)
    assert isinstance(src, ReplaySource)
    bus, jbus = _recording(MemoryFrameBus)(), _recording(JMemoryFrameBus)()
    _run_worker(bus, url=url, frames=6, query=True)
    _run_worker(jbus, JIngestWorker, JWorkerConfig, url=url, frames=6, query=True)
    _same_publishes(bus.log, jbus.log)
    assert [m["packet"] for _, _, m in bus.log] == list(range(6))


def test_flight_recorder_writes_the_trace_the_jax_worker_writes(tmp_path):
    """``trace_dir``: each worker records what it published (the pattern
    seed of a synthetic frame); the two packages' traces hold the same
    events, arrival times aside, and the port's replays through
    ``replay://`` to the same frames."""
    from video_edge_ai_proxy_tpu_torch.replay.trace import iter_frames, read_trace

    url = "test://pattern?w=80&h=48&fps=30&gop=4&pace=0&frames=9"
    for pkg, (worker_cls, cfg_cls, bus) in {
            "torch": (IngestWorker, WorkerConfig, _recording(MemoryFrameBus)()),
            "jax": (JIngestWorker, JWorkerConfig, JMemoryFrameBus())}.items():
        cfg = cfg_cls(rtsp_endpoint=url, device_id="cam1", bus_backend="memory", max_frames=9,
                      trace_dir=str(tmp_path / pkg))
        bus.touch_query("cam1")
        worker_cls(cfg, bus=bus).run()
        if pkg == "torch":
            published = bus.log

    def events(pkg):
        _, evs = read_trace(str(tmp_path / pkg / "cam1.vtrace"))
        return [{k: v for k, v in ev.items() if k not in ("t_ms", "ts_ms")}
                for ev in iter_frames(evs, "cam1")]

    assert len(events("torch")) == 9 and events("torch") == events("jax")
    replayed = _recording(MemoryFrameBus)()
    _run_worker(replayed, url=f"replay://{tmp_path / 'torch' / 'cam1.vtrace'}?pace=0", frames=9,
                query=True)
    assert len(replayed.log) == 9
    for (_, frame, meta), (_, want, want_meta) in zip(replayed.log, published):
        np.testing.assert_array_equal(frame, want)
        assert meta["packet"] == want_meta["packet"]


def test_parse_fresh_status_agrees_with_jax():
    now = int(time.time() * 1000)
    beats = [None, "", "not json", "null", "5", "[1, 2]", '"text"', "{}",
             json.dumps({"pid": 7, "ts_ms": now}),
             json.dumps({"pid": 7, "ts_ms": now - STATUS_FRESH_MS + 1}),
             json.dumps({"pid": 7, "ts_ms": now - STATUS_FRESH_MS}),
             json.dumps({"pid": 7, "ts_ms": now - 60_000})]
    got = [parse_fresh_status(raw, now) for raw in beats]
    assert got == [jparse_fresh_status(raw, now) for raw in beats]
    assert [bool(g) for g in got] == [False] * 7 + [False, True, True, False, False]


def test_env_contract_matches_jax(monkeypatch):
    env = {"rtsp_endpoint": unpaced(), "device_id": "cam7", "rtmp_endpoint": "",
           "in_memory_buffer": "3", "disk_buffer_path": "", "vep_shm_dir": "/dev/shm/x",
           "vep_bus_backend": "shm", "vep_redis_addr": "10.0.0.1:6380",
           "vep_redis_password": "pw", "vep_redis_db": "2", "vep_max_frames": "9",
           "vep_trace_dir": "/traces"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(WorkerConfig.from_env()) == dataclasses.asdict(
        JWorkerConfig.from_env())


def test_worker_process_feeds_the_engine_on_the_cpu(shm_dir):
    """One worker process per camera on a shm ring directory, read by the
    port's engine through ``open_bus("shm", dir)``: the subscribed stream
    is served, the engine keeps its worker decoding every frame, and the
    worker exits 0 at SIGTERM."""
    env = dict(os.environ, PYTHONPATH=ROOT, device_id="cam0", vep_shm_dir=shm_dir,
               vep_bus_backend="shm", in_memory_buffer="1",
               rtsp_endpoint="test://pattern?w=128&h=96&fps=30&gop=30")
    proc = subprocess.Popen([sys.executable, "-m", "video_edge_ai_proxy_tpu_torch.ingest.worker"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    bus = open_bus("shm", shm_dir)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5), device="cpu")
    results = engine.subscribe(["cam0"], timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    try:
        engine.start()
        deadline = time.monotonic() + 60
        while len(got) < 20:
            assert proc.poll() is None, proc.stdout.read().decode()
            assert time.monotonic() < deadline, "the worker's frames were not served"
            time.sleep(0.05)
        hb = parse_fresh_status(bus.kv_get(KEY_STATUS_PREFIX + "cam0"), int(time.time() * 1000))
    finally:
        engine.stop()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        finally:
            proc.kill()
        bus.close()
    reader.join(10)
    out = proc.stdout.read().decode()
    assert rc == 0, out
    assert "ingest worker down: device=cam0" in out
    assert {r.device_id for r in got} == {"cam0"}
    assert all(r.model == "tiny_yolov8" and r.latency_ms >= 0 for r in got)
    # Kept hot: the worker decoded the frames between keyframes too.
    assert hb["decoded"] > hb["keyframes"] >= 1, hb
    packets = [r.frame_packet for r in got]
    assert packets == sorted(packets) and len(set(packets)) == len(packets)

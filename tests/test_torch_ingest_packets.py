"""The port's packet mode of the ingest worker against the JAX package's, on
one encoded H.264 clip (``write_test_video``, 320x240, 60 frames, a
keyframe every 10; once for the module, with and without a mic track).

- The two workers, each on its own package's ``MemoryFrameBus`` and
  ``PacketSource`` over the same file URL, publish the same ``FrameMeta``
  sequence (all fields but the wall-clock ``timestamp_ms``) and bit-equal
  frames, with the decode gate open and in keyframe-only mode.
- With ``disk_buffer_path`` both archive the same stream-copied segments
  (``PacketGopSegment``), with the audio track and with a GOP cut at
  ``MAX_GOP_BYTES``; the trailing GOP is flushed at the end.
- With ``rtmp_endpoint`` set to an ``.flv`` file and the ``proxy_rtmp``
  toggle turned on mid-GOP, both relay from the buffered GOP's keyframe on,
  the same packets.
- ``open_source`` routes each URL to the same source kind and counts the
  same ``vep_source_opens_total{kind}`` label under ``vep_source``, and to
  OpenCV when the shim is unavailable.
- A ``python -m`` worker on a file endpoint loads no torch.

Tolerance: none; every comparison is exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.ingest import av as jav
from video_edge_ai_proxy_tpu.ingest import sources as jsources
from video_edge_ai_proxy_tpu.ingest import worker as jworker
from video_edge_ai_proxy_tpu.obs import registry as jregistry
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.ingest import av
from video_edge_ai_proxy_tpu_torch.ingest import sources
from video_edge_ai_proxy_tpu_torch.ingest import worker
from video_edge_ai_proxy_tpu_torch.obs import registry


@pytest.fixture(scope="module", autouse=True)
def _libav():
    """Both shims build here (at their first use, not at import)."""
    if not (av.available() and jav.available()):
        pytest.skip("the FFmpeg development files are not on this host")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N, FPS, GOP = 320, 240, 60, 30.0, 10
PACKAGES = {
    "port": (worker, sources, MemoryFrameBus, av),
    "jax": (jworker, jsources, JMemoryFrameBus, jav),
}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_packets") / "cam.mp4")
    jav.write_test_video(path, W, H, frames=N, fps=FPS, gop=GOP)
    return path


@pytest.fixture(scope="module")
def audio_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_packets_audio") / "cam_audio.mp4")
    jav.write_test_video(path, W, H, frames=N, fps=FPS, gop=GOP, audio=True)
    return path


def run_worker(name, path, *, query=True, keyframe_only=False, setup=None, **cfg):
    """One package's worker over ``path`` for N packets on its own memory
    bus; returns (worker, [(frame, meta)] published, bus)."""
    wmod, smod, bus_cls, _ = PACKAGES[name]
    bus = bus_cls()
    if query:
        bus.touch_query("camfile")
    if keyframe_only:
        bus.set_keyframe_only("camfile", True)
    published = []
    orig = bus.publish

    def record(device_id, data, meta):
        published.append((data.copy(), meta))
        return orig(device_id, data, meta)

    bus.publish = record
    w = wmod.IngestWorker(wmod.WorkerConfig(rtsp_endpoint=path, device_id="camfile",
                                            max_frames=N, **cfg),
                          bus=bus, source=smod.PacketSource(path))
    if setup is not None:
        setup(w, bus)
    w.run()
    return w, published, bus


def meta_fields(meta):
    out = dict(vars(meta))
    out.pop("timestamp_ms")   # the wall clock at demux
    return out


def starts_at_a_keyframe_of(video, source_video) -> bool:
    """``video``'s payloads are a run of ``source_video``'s that begins at
    one of its keyframes."""
    payloads = [p[-1] for p in source_video]
    i = payloads.index(video[0][-1])
    return source_video[i][3] and payloads[i:i + len(video)] == [p[-1] for p in video]


def demux(path):
    with jav.PacketDemuxer(path) as d:
        pkts = []
        while (p := d.read(want_data=True)) is not None:
            pkts.append((p.pts, p.dts, p.duration, p.is_keyframe, p.is_audio, p.data))
        return d.audio_info is not None, pkts


@pytest.mark.parametrize("mode", ["gate_open", "keyframe_only", "idle"])
def test_both_workers_publish_the_same_frames_and_metas(clip, mode):
    runs = {name: run_worker(name, clip, query=mode != "idle",
                             keyframe_only=mode == "keyframe_only")
            for name in PACKAGES}
    (pw, pub, _), (jw, jpub, _) = runs["port"], runs["jax"]
    assert len(pub) == len(jpub) > 0
    for (pf, pm), (jf, jm) in zip(pub, jpub):
        np.testing.assert_array_equal(pf, jf)
        assert meta_fields(pm) == meta_fields(jm)
    for attr in ("_packets", "_keyframes", "_decoded", "_published", "_audio_packets"):
        assert getattr(pw, attr) == getattr(jw, attr), attr
    assert pw._packets == N and pw._keyframes == N // GOP
    if mode == "gate_open":
        assert len(pub) >= N - 2                      # codec delay may hold a few
        assert {m.frame_type for _, m in pub} <= {"I", "P", "B"}
        pts = [m.pts for _, m in pub]
        assert pts == sorted(pts) and pts[0] == 0
    else:
        assert pw._decoded <= pw._keyframes
        assert all(m.is_keyframe for _, m in pub)


def test_heartbeats_say_packet_source_alike(clip):
    beats = {}
    for name in PACKAGES:
        w, _, bus = run_worker(name, clip)
        beats[name] = json.loads(bus.kv_get(worker.KEY_STATUS_PREFIX + "camfile"))
    for b in beats.values():
        for k in ("pid", "ts_ms", "fps"):
            b.pop(k)
    assert beats["port"] == beats["jax"]
    assert beats["port"]["source"] == "packet" and beats["port"]["width"] == W


@pytest.mark.parametrize("which", ["video", "audio", "gop_cut"])
def test_archive_segments_demux_equal(clip, audio_clip, tmp_path, which):
    path = audio_clip if which == "audio" else clip
    cut = None
    if which == "gop_cut":
        _, pkts = demux(clip)
        cut = int(sum(len(p[-1]) for p in pkts[:GOP]) * 0.6)

    def setup(w, bus):
        if cut is not None:
            w.MAX_GOP_BYTES = cut

    segs = {}
    for name in PACKAGES:
        arch = tmp_path / name
        w, _, _ = run_worker(name, path, query=False, disk_buffer_path=str(arch), setup=setup)
        assert w._decoded <= w._keyframes          # the archive never pins the gate
        files = sorted(os.listdir(arch / "camfile"))
        assert all(f.endswith(".mp4") for f in files)
        segs[name] = sorted((f.split("_", 1)[1].split(".")[0].split("-")[0],
                             demux(str(arch / "camfile" / f))) for f in files)
    assert segs["port"] == segs["jax"]
    assert len(segs["port"]) == N // GOP
    total_video = 0
    for _, (has_audio, pkts) in segs["port"]:
        video = [p for p in pkts if not p[4]]
        assert video[0][3] and video[0][0] == 0       # a keyframe at the head, rebased
        assert has_audio == (which == "audio")
        assert any(p[4] for p in pkts) == (which == "audio")
        total_video += len(video)
    _, source = demux(path)
    source_video = [p for p in source if not p[4]]
    for _, (_, pkts) in segs["port"]:
        assert starts_at_a_keyframe_of([p for p in pkts if not p[4]], source_video)
    if which == "gop_cut":
        assert 0 < total_video < N                   # each GOP cut at the byte cap
    else:
        assert total_video == N                      # every packet archived, as fed
        fed = sorted(p[-1] for p in source_video)
        got = sorted(p[-1] for _, (_, pkts) in segs["port"] for p in pkts if not p[4])
        assert got == fed


@pytest.mark.parametrize("which", ["video", "audio"])
def test_file_passthrough_flushes_the_buffered_gop_alike(clip, audio_clip, tmp_path, which):
    path = audio_clip if which == "audio" else clip
    relayed = {}
    for name in PACKAGES:
        sink = str(tmp_path / f"{name}.flv")

        def setup(w, bus):
            grab, count = w.source.grab, [0]

            def counting_grab():
                # Toggle on in the middle of the second GOP.
                count[0] += 1
                if count[0] == int(1.5 * GOP):
                    bus.set_proxy_rtmp("camfile", True)
                return grab()

            w.source.grab = counting_grab

        w, _, _ = run_worker(name, path, query=False, rtmp_endpoint=sink, setup=setup)
        assert w._passthrough.written > 0 and w._decoded <= w._keyframes
        relayed[name] = demux(sink)
    assert relayed["port"] == relayed["jax"]
    _, pkts = relayed["port"]
    video = [p for p in pkts if not p[4]]
    assert video[0][3]                               # starts at the buffered GOP's keyframe
    _, source = demux(path)
    source_video = [p for p in source if not p[4]]
    assert starts_at_a_keyframe_of(video, source_video)
    assert [p[-1] for p in video] == [p[-1] for p in source_video[-len(video):]]
    # From the head of the GOP the toggle fell in (the grab count that
    # turns it on includes the mic's packets).
    assert len(video) % GOP == 0 and N - 2 * GOP <= len(video) <= N
    assert any(p[4] for p in pkts) == (which == "audio")


def _opens(reg, kind):
    return reg.counter("vep_source_opens_total", "Video sources opened, by backend kind",
                       ("kind",)).labels(kind).value


@pytest.mark.parametrize("prefer", ["", "packet", "opencv"])
@pytest.mark.parametrize("url", ["test://pattern?w=64&h=48", "clip", "rtsp://camera.local/x"])
def test_open_source_routes_and_labels_as_jax(clip, monkeypatch, prefer, url):
    url = clip if url == "clip" else url
    monkeypatch.setenv("vep_source", prefer)
    monkeypatch.setenv("vep_av_options", "decode_threads=1")
    kinds = {}
    for name, smod, reg in (("port", sources, registry), ("jax", jsources, jregistry)):
        before = {k: _opens(reg, k) for k in ("synthetic", "packet", "opencv")}
        src = smod.open_source(url)
        after = {k: _opens(reg, k) for k in ("synthetic", "packet", "opencv")}
        kinds[name] = (type(src).__name__, src.kind, {k for k in after if after[k] > before[k]},
                       getattr(src, "av_options", None))
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"][2] == {kinds["port"][1]}


def test_open_source_takes_opencv_when_the_shim_is_unavailable(clip, monkeypatch):
    monkeypatch.delenv("vep_source", raising=False)
    monkeypatch.setattr(av, "available", lambda: False)
    monkeypatch.setattr(jav, "available", lambda: False)
    assert type(sources.open_source(clip)).__name__ == type(jsources.open_source(clip)).__name__ \
        == "OpenCVSource"
    # vep_source=packet insists on the shim in both.
    monkeypatch.setenv("vep_source", "packet")
    assert isinstance(sources.open_source(clip), sources.PacketSource)
    assert isinstance(jsources.open_source(clip), jsources.PacketSource)


def test_packet_source_properties_equal_jax(audio_clip):
    got = {}
    for name, smod in (("port", sources), ("jax", jsources)):
        src = smod.PacketSource(audio_clip)
        src.open()
        seen = []
        for _ in range(30):
            info = src.grab()
            pkt = src.packet_with_data()
            frame = None if info.is_audio else src.retrieve()
            seen.append((vars(info) | {"timestamp_ms": 0}, pkt.data, pkt.is_audio,
                         src.last_frame_type, src.last_frame_pts,
                         None if frame is None else frame.tobytes()))
        got[name] = ((src.width, src.height, src.fps), src.stream_info.codec_name,
                     src.audio_info.codec_name, seen)
        src.close()
        assert src.stream_info is None and src.grab() is None
    assert got["port"] == got["jax"]


WORKER_ON_FILE = """
import json, sys
from video_edge_ai_proxy_tpu_torch.bus import open_bus
from video_edge_ai_proxy_tpu_torch.ingest import worker
worker.main(["--max_frames", "30"])
bus = open_bus("shm", sys.argv[1])
print(json.dumps({"status": json.loads(bus.kv_get(worker.KEY_STATUS_PREFIX + "camfile")),
                  "loaded": sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax"))}))
"""


def test_worker_on_a_file_endpoint_loads_no_torch(clip, shm_dir):
    env = dict(os.environ, PYTHONPATH=ROOT, rtsp_endpoint=clip, device_id="camfile",
               vep_shm_dir=shm_dir, vep_bus_backend="shm", in_memory_buffer="1")
    env.pop("vep_source", None)
    proc = subprocess.run([sys.executable, "-c", WORKER_ON_FILE, shm_dir], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["status"]["source"] == "packet" and out["status"]["packets"] == 30
    assert "stream=camfile" in proc.stdout           # the worker's log context

"""The port's chaos soak (``video_edge_ai_proxy_tpu_torch/replay/harness.py``
``run_fleet_soak`` and its helpers) against the JAX package's harness.

- ``_ReplayCamera`` publishes the same bytes and metadata as JAX's camera
  over one recorded trace, with no fault and inside black, frozen, gap,
  kill and flap windows; the port's shared render memo renders each frame
  once and gives ``decode_frame``'s bytes.
- ``StallBus`` and ``_FlakyCloud`` behave as JAX's.
- JAX's ``TestFleetSoakMini`` (a 4-stream, 2-family soak with a kill and
  re-add) through both packages, and the artifacts' key sets section by
  section, the plain soak and the quality soak.
- Mini soaks held to ``tools/torch_soak_replay.py``'s gates: the quality
  kinds (each detected within 5 s, no false positive, a canary episode)
  and the resilience kinds (the breaker opened and closed, the uplink
  conserved and drained); the tool's legs end to end on the CPU.

Everything runs on the CPU with the tiny twins at 48x64 or 96x128."""

import importlib.util
import json
import os
import threading
import time
import urllib.error

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.replay import harness as jharness
from video_edge_ai_proxy_tpu.replay.faults import FaultEvent as JFaultEvent
from video_edge_ai_proxy_tpu.replay.faults import FaultPlan as JFaultPlan
from video_edge_ai_proxy_tpu.replay.player import TracePlayer as JTracePlayer
from video_edge_ai_proxy_tpu.replay.trace import decode_frame as jdecode_frame
from video_edge_ai_proxy_tpu_torch.replay import harness as tharness
from video_edge_ai_proxy_tpu_torch.replay.faults import QUALITY_KINDS, FaultEvent, FaultPlan
from video_edge_ai_proxy_tpu_torch.replay.player import TracePlayer
from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12       # the camera trace's frames a stream (1 ms apart)
N_PUBLISH = 20      # publishes a camera test waits for: past the trace's end


@pytest.fixture(autouse=True)
def _clean_tracers():
    """The soak and the e2e run leave their span rings filled (the tools
    export them after the run); both packages' process-wide tracers get
    their config back and are emptied after each test, so the tests that
    follow in the same worker start from empty rings."""
    from video_edge_ai_proxy_tpu.obs import tracer as jtracer
    from video_edge_ai_proxy_tpu_torch.obs import tracer

    saved = [(t, t.enabled, t.sample_every) for t in (tracer, jtracer)]
    yield
    for t, enabled, every in saved:
        t.configure(enabled=enabled, sample_every=every)
        t.clear()


@pytest.fixture(scope="module")
def cam_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cams") / "cams.vtrace")
    record_synthetic_trace(path, ["cam0", "cam1"], width=32, height=24, fps=1000.0, gop=5,
                           frames=N_FRAMES)
    return path


class RecordingBus:
    """A bus that keeps every published frame and meta, and sets ``done``
    after ``n``; ``fail`` (an exception instance) makes publishes raise it."""

    def __init__(self, n=N_PUBLISH, fail=None):
        self.n = n
        self.fail = fail
        self.frames, self.metas, self.created = [], [], []
        self.done = threading.Event()
        self.attempts = 0

    def create_stream(self, device_id, nbytes):
        self.created.append((device_id, nbytes))

    def publish(self, device_id, frame, meta):
        self.attempts += 1
        if self.fail is not None:
            if self.attempts >= self.n:
                self.done.set()
            raise self.fail
        self.frames.append(np.array(frame))
        self.metas.append(meta)
        if len(self.frames) >= self.n:
            self.done.set()
        return len(self.frames)


def _run_camera(cam, bus, until=None, timeout=20.0):
    cam.start()
    if until is None:
        assert bus.done.wait(timeout), "the camera did not publish"
    else:
        deadline = time.monotonic() + timeout
        while not until() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert until(), "the camera's window did not show"
    cam.stop_ev.set()
    cam.join(timeout=5)


def _cameras(trace, fault=None, bus_fail=None, memo=None, wrap=None):
    """The same camera of each package over ``trace``, its fault window set
    before it starts; (port camera, its bus, JAX camera, its bus)."""
    out = []
    for mod, player in ((tharness, TracePlayer), (jharness, JTracePlayer)):
        bus = RecordingBus(fail=bus_fail)
        target = wrap(mod, bus) if wrap else bus
        events = player(trace).frame_events("cam0")
        if mod is tharness:
            cam = mod._ReplayCamera(target, "cam0", events, threading.Event(), memo)
        else:
            cam = mod._ReplayCamera(target, "cam0", events, threading.Event())
        if fault == "killed":
            cam.killed.set()
        elif fault:
            setattr(cam, fault, time.monotonic() + 60.0)
        out += [cam, bus]
    return out


def _meta_fields(meta):
    return (meta.width, meta.height, meta.channels, meta.pts, meta.dts, meta.packet,
            meta.is_keyframe, meta.frame_type)


@pytest.mark.parametrize("fault", [None, "black_until", "frozen_until"])
def test_replay_camera_publishes_jax_bytes(cam_trace, fault):
    tcam, tbus, jcam, jbus = _cameras(cam_trace, fault)
    for cam, bus in ((tcam, tbus), (jcam, jbus)):
        _run_camera(cam, bus)
    n = min(len(tbus.frames), len(jbus.frames))
    assert n >= N_PUBLISH
    for i in range(n):
        assert tbus.frames[i].tobytes() == jbus.frames[i].tobytes(), f"frame {i}"
        assert _meta_fields(tbus.metas[i]) == _meta_fields(jbus.metas[i])
    assert tbus.created == jbus.created == [("cam0", 24 * 32 * 3)]
    if fault == "black_until":
        assert not any(f.any() for f in tbus.frames[:n])
    elif fault == "frozen_until":
        first = jdecode_frame(JTracePlayer(cam_trace).frame_events("cam0")[0])
        assert all(f.tobytes() == first.tobytes() for f in tbus.frames[:n])
    else:
        # Past the trace's end the camera loops: frame N_FRAMES is frame 0.
        assert tbus.frames[N_FRAMES].tobytes() == tbus.frames[0].tobytes()
        assert tbus.frames[1].tobytes() != tbus.frames[0].tobytes()


@pytest.mark.parametrize("fault", ["gap_until", "killed"])
def test_replay_camera_suppresses_as_jax(cam_trace, fault):
    tcam, tbus, jcam, jbus = _cameras(cam_trace, fault)
    for cam, bus in ((tcam, tbus), (jcam, jbus)):
        _run_camera(cam, bus, until=lambda c=cam: c.suppressed >= N_PUBLISH)
    assert tcam.published == jcam.published == 0
    assert tbus.frames == jbus.frames == []


def test_replay_camera_counts_a_flapping_bus_as_jax(cam_trace):
    def wrap(mod, bus):
        stall = mod.StallBus(bus)
        stall.flap_for(60.0)
        return stall

    tcam, tbus, jcam, jbus = _cameras(cam_trace, wrap=wrap)
    for cam, bus in ((tcam, tbus), (jcam, jbus)):
        _run_camera(cam, bus, until=lambda c=cam: c.suppressed >= N_PUBLISH)
        # A flap keeps the stream: no re-create.
        assert bus.created == [("cam0", 24 * 32 * 3)] and cam.published == 0


def test_replay_camera_recreates_after_a_raced_drop_as_jax(cam_trace):
    tcam, tbus, jcam, jbus = _cameras(cam_trace, bus_fail=ValueError("stream dropped"))
    for cam, bus in ((tcam, tbus), (jcam, jbus)):
        _run_camera(cam, bus, until=lambda c=cam: c.suppressed >= 5)
        assert cam.published == 0
        # Each failed publish marks the stream gone; the next frame
        # re-creates it first.
        assert len(bus.created) >= 5


def test_render_memo_renders_each_frame_once_with_decode_frame_bytes(cam_trace):
    """More camera threads than cores on one memo, with a short switch
    interval: every frame is still rendered once."""
    import sys

    memo = tharness._RenderMemo()
    events = TracePlayer(cam_trace).frame_events("cam0")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [memo.frame(ev) for ev in events * 3])
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert memo.renders == N_FRAMES
    for ev in events:
        got = memo.frame(ev)
        assert not got.flags.writeable
        assert got.tobytes() == jdecode_frame(ev).tobytes()
    # Two cameras of one soak share renders: cam1's frames are cam0's.
    for ev in TracePlayer(cam_trace).frame_events("cam1"):
        memo.frame(ev)
    assert memo.renders == N_FRAMES


def test_render_memo_bound_evicts_oldest(cam_trace):
    events = TracePlayer(cam_trace).frame_events("cam0")
    nbytes = jdecode_frame(events[0]).nbytes
    memo = tharness._RenderMemo(max_bytes=3 * nbytes)
    for ev in events:
        memo.frame(ev)
    assert len(memo._frames) == 3 and memo._bytes == 3 * nbytes
    memo.frame(events[-1])
    assert memo.renders == N_FRAMES
    memo.frame(events[0])
    assert memo.renders == N_FRAMES + 1
    tiny = tharness._RenderMemo(max_bytes=1)
    assert tiny.frame(events[0]).tobytes() == jdecode_frame(events[0]).tobytes()
    assert tiny.frame(events[0]).tobytes() == jdecode_frame(events[0]).tobytes()
    assert tiny.renders == 2 and not tiny._frames


def test_stall_bus_equals_jax():
    for mod in (tharness, jharness):
        inner = RecordingBus(n=100)
        bus = mod.StallBus(inner)
        assert bus.frames is inner.frames      # everything else delegates
        frame = np.zeros((2, 2, 3), np.uint8)
        assert bus.publish("d", frame, "m") == 1
        bus.stall_for(0.2)
        t0 = time.monotonic()
        bus.publish("d", frame, "m")
        assert time.monotonic() - t0 >= 0.15
        bus.flap_for(0.5)
        with pytest.raises(ConnectionError, match="bus_flap"):
            bus.publish("d", frame, "m")
        assert len(inner.frames) == 2


def test_flaky_cloud_equals_jax():
    counts = []
    for mod in (tharness, jharness):
        cloud = mod._FlakyCloud()
        assert cloud.post_annotations("u", [{}, {}]) == b"{}"
        cloud.down_until = time.monotonic() + 60.0
        for _ in range(3):
            with pytest.raises(urllib.error.URLError, match="uplink_down"):
                cloud.post_annotations("u", [{}])
        cloud.down_until = 0.0
        cloud.post_annotations("u", [{}] * 5)
        counts.append((cloud.posts, cloud.post_failures, cloud.delivered))
    assert counts[0] == counts[1] == (5, 3, 7)


def test_default_fleet_and_prewarm_entries():
    assert tharness.default_fleet("cpu") == jharness.default_fleet("cpu") == \
        tharness.FLEET_CPU
    assert tharness.default_fleet("cuda") == jharness.FLEET_TPU == tharness.FLEET_CUDA
    assignment = {f"fleet{i:02d}": m for i, m in enumerate(
        m for m, n in tharness.FLEET_CPU.items() for _ in range(n))}
    # JAX's prewarm loop: each frame model's buckets up to the first that
    # holds its streams.
    want = []
    for m, n in tharness.FLEET_CPU.items():
        for b in (1, 2, 4, 8, 16):
            want.append([96, 128, b, m])
            if b >= n:
                break
    assert tharness._prewarm_entries(assignment, (96, 128), (16, 1, 8, 2, 4)) == want
    assert tharness._prewarm_entries({"c0": "tiny_videomae"}, (96, 128), (1, 2)) == []


MINI = dict(duration_s=5.0, fleet={"tiny_yolov8": 2, "tiny_resnet": 2}, src_hw=(48, 64),
            sample_every_s=1.0, timeline_bin_s=2.0)


def _keys(obj, depth=2):
    """The nested key sets of an artifact, ``depth`` levels down."""
    if not isinstance(obj, dict) or depth == 0:
        return "value"
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def _mini_plan(mod_event, mod_plan):
    return mod_plan([mod_event(at_s=1.0, kind="camera_kill", device_id="fleet00"),
                     mod_event(at_s=2.5, kind="camera_restore", device_id="fleet00")])


@pytest.mark.parametrize("leg", ["churn", "quality"])
def test_mini_soak_equals_jax(leg):
    """JAX's TestFleetSoakMini through both packages (its churn plan), and a
    quality leg of the same fleet: the same acceptance fields, and the same
    keys in every section of the artifact."""
    quality = QUALITY_KINDS if leg == "quality" else ()
    jout = jharness.run_fleet_soak(
        **MINI, fault_plan=_mini_plan(JFaultEvent, JFaultPlan) if not quality else None,
        quality_kinds=quality)
    tout = tharness.run_fleet_soak(
        **MINI, fault_plan=_mini_plan(FaultEvent, FaultPlan) if not quality else None,
        quality_kinds=quality, device="cpu")
    for out in (jout, tout):
        assert out["streams"] == 4
        assert out["misrouted_results"] == 0
        assert sum(out["published"].values()) > 0
        assert out["step_cache"]["final"] >= 1
        assert out["backend"] == "cpu"
    assert [f["kind"] for f in tout["faults_applied"]] == \
        [f["kind"] for f in jout["faults_applied"]]
    if leg == "churn":
        assert [f["kind"] for f in tout["faults_applied"]] == ["camera_kill", "camera_restore"]
        assert tout["suppressed"]["fleet00"] > 0
        assert tout["quality"] is jout["quality"] is None
    else:
        assert sorted(f["kind"] for f in tout["quality"]["faults"]) == sorted(QUALITY_KINDS)
    # The sections of the artifact, key for key (the metrics snapshot and
    # the perf, slo and stage-breakdown sections hold what each package's
    # planes registered: their top keys).
    for key in ("per_family_latency_ms", "step_cache", "published", "suppressed",
                "resilience", "quality"):
        assert _keys(tout[key], 2) == _keys(jout[key], 2), key
    assert set(tout) == set(jout)
    assert set(tout["obs"]) == set(jout["obs"])
    assert set(tout["obs"]["trace"]) == set(jout["obs"]["trace"])
    tres, jres = tout["resilience"], jout["resilience"]
    assert set(tres["ladder"]) == set(jres["ladder"])
    assert _keys(tres["uplink"], 2) == _keys(jres["uplink"], 2)
    assert set(tres["uplink"]["breaker"]) == set(jres["uplink"]["breaker"])
    if leg == "quality":
        tq, jq = tout["quality"], jout["quality"]
        assert set(tq["canary"]) == set(jq["canary"])
        assert [sorted(f) for f in tq["faults"]] == [sorted(f) for f in jq["faults"]]
    for section in ("perf", "slo"):
        assert (tout[section] is None) == (jout[section] is None)
    assert tout["slo"] is None or set(tout["slo"]) == set(jout["slo"])
    assert set(tout["bucket_fill_timeline"][0]) == set(jout["bucket_fill_timeline"][0])


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_soak_replay", os.path.join(ROOT, "tools", "torch_soak_replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = {"tiny_yolov8": 2, "tiny_resnet": 1, "tiny_vit": 1}


def test_quality_mini_soak_passes_the_tools_gates():
    """The quality kinds on a 4-stream soak, held to
    tools/torch_soak_replay.py's gates: each fault detected within 5 s, no
    false positive, a canary episode, and the chaos gates."""
    tool = _tool()
    soak = tharness.run_fleet_soak(duration_s=12.0, fleet=SMALL, src_hw=(48, 64),
                                   quality_kinds=QUALITY_KINDS, device="cpu")
    quality = soak["quality"]
    assert sorted(f["kind"] for f in quality["faults"]) == sorted(QUALITY_KINDS)
    assert tool.quality_failures(quality, QUALITY_KINDS, 5.0) == []
    assert tool.chaos_failures(soak, 12.0) == []
    assert quality["canary_watchdog_episodes"] >= 1
    # The detector's streams detect (the class prior zeroed in place).
    streams = soak["obs"]["quality"]["streams"]
    assert streams["fleet01"]["det_ema"] > 0


def test_resilience_mini_soak_passes_the_tools_gates():
    tool = _tool()
    soak = tharness.run_fleet_soak(duration_s=10.0, fleet=SMALL, src_hw=(48, 64),
                                   fault_plan=FaultPlan.resilience(10.0), device="cpu")
    assert [f["kind"] for f in soak["faults_applied"]] == \
        ["uplink_down", "bus_flap", "device_stall"]
    assert tool.chaos_failures(soak, 10.0) == []
    uplink = soak["resilience"]["uplink"]
    assert uplink["conserved"] and uplink["final_queue_depth"] == 0
    assert uplink["post_failures"] > 0 and uplink["breaker"]["transitions"].get("open")
    assert uplink["breaker"]["state"] == "closed"


def test_the_tools_legs_on_the_cpu(tmp_path, capsys):
    """tools/torch_soak_replay.py end to end on the CPU (the default churn
    plan, no e2e): the determinism leg identical, the soak's legs printed,
    the artifact written."""
    tool = _tool()
    out = tmp_path / "soak.json"
    tool.main(["--device", "cpu", "--duration", "4", "--no-e2e", "--frames", "4",
               "--out", str(out)])
    legs = {}
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            legs[rec.get("leg")] = rec
    assert set(legs) == {"determinism", "soak", "resilience", "slo", "summary"}
    assert legs["determinism"]["identical"] and legs["summary"]["misrouted_results"] == 0
    artifact = json.loads(out.read_text())
    assert artifact["soak"]["streams"] == 16
    assert [f["kind"] for f in artifact["soak"]["faults_applied"]] == [
        "camera_kill", "frame_gap", "camera_restore", "bus_stall", "slow_subscriber"]


def test_tool_refuses_the_fleet_leg_and_unknown_kinds(capsys, monkeypatch, tmp_path):
    """Unknown fault kinds are refused at parse time; ``--fleet N`` runs
    ``run_fleet_obs`` (stubbed here, with one gate failing) and refuses a
    fleet leg whose gates fail, with JAX's message."""
    from video_edge_ai_proxy_tpu_torch.replay import harness

    tool = _tool()
    for argv in (["--faults", "meteor"], ["--faults", "camera_kill"]):
        with pytest.raises(SystemExit) as err:
            tool.main(["--device", "cpu"] + argv)
        assert err.value.code == 2
    calls = []

    def fake_fleet_obs(**kw):
        calls.append(kw)
        return {"backend": "cpu", "members": kw["n_members"], "client_results": [1, 1],
                "health": [], "lint_errors": [], "counter_mismatches": [{"family": "x"}],
                "trace_problems": [],
                "gates": {"merged_lint_clean": True, "member_lint_clean": True,
                          "all_members_present": True, "stitched_traces": 1,
                          "counters_conserved": False, "fleet_trace_valid": True}}

    monkeypatch.setattr(harness, "run_fleet_obs", fake_fleet_obs)
    out = tmp_path / "fleet.json"
    with pytest.raises(SystemExit) as err:
        tool.main(["--device", "cpu", "--fleet", "3", "--fleet-out", str(out)])
    assert "merged counters != member sums" in str(err.value)
    assert calls[0]["n_members"] == 3 and calls[0]["device"] == "cpu"
    assert json.loads(out.read_text())["tool"] == "torch_soak_replay"


def test_a_finished_soak_leaves_no_engine_alive():
    """The soak's engine (with its quality plane, canary and triggered
    profiler) is collected once the soak returns: nothing of the port keeps
    a stopped engine."""
    import gc

    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine

    gc.collect()
    before = {id(o) for o in gc.get_objects() if isinstance(o, InferenceEngine)}
    out = tharness.run_fleet_soak(duration_s=2.0, fleet={"tiny_yolov8": 1, "tiny_vit": 1},
                                  src_hw=(48, 64), sample_every_s=1.0, timeline_bin_s=2.0,
                                  quality_kinds=("black_frame",), profile_on_burn=True,
                                  device="cpu")
    assert out["streams"] == 2
    del out
    gc.collect()
    alive = [o for o in gc.get_objects()
             if isinstance(o, InferenceEngine) and id(o) not in before]
    assert alive == []

"""The port's ``Server`` on the CPU, driven as ``tests/test_serve.py``'s
``TestEndToEnd`` and ``TestInferenceEndToEnd`` drive the JAX one: REST
process CRUD and log follow, the six gRPC methods (``VideoLatestImage``
with per-connection cursors, ``ListStreams``, ``Annotate`` reaching a
local sink as a signed POST, ``Proxy``, ``Storage``'s signed PUT,
``Inference`` with its model filter), the admin RPCs, the observability
routes, a killed worker restarted, and workers re-adopted across two
servers on one data dir. One engine server (``tiny_yolov8``,
``device="cpu"``, ephemeral ports) serves the module; every wait has a
timeout of its own.

Beside it runs the JAX package's ``Server`` on the same weights, and the
same requests go to both: the answers of ``/api/v1/process``,
``/api/v1/processlist``, ``/api/v1/settings``, the logs and the error
codes, the ``ListStreams`` fields and one frame's ``Inference`` result,
field by field with ``track_id`` and the box, must agree. Last, the wire's
packages blocked in a fresh interpreter: the server's planes import and
build without them, and ``Server.start()`` raises ``ImportError``."""

import http.server
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.proto import pb as jpb
from video_edge_ai_proxy_tpu.proto import video_streaming_pb2_grpc as jpb_grpc
from video_edge_ai_proxy_tpu.replay import checksum as jchecksum
from video_edge_ai_proxy_tpu.utils.checkpoint import save_msgpack
from video_edge_ai_proxy_tpu.utils.config import Config as JaxConfig
from video_edge_ai_proxy_tpu.utils.signing import verify_signature
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2 as pb
from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2_grpc as pb_grpc
from video_edge_ai_proxy_tpu_torch.serve import StreamProcess
from video_edge_ai_proxy_tpu_torch.serve.server import Server
from video_edge_ai_proxy_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synth_url(frames=0, w=32, h=24):
    extra = f"&frames={frames}" if frames else ""
    return f"test://pattern?w={w}&h={h}&fps=30&gop=5{extra}"


def wait_for(cond, timeout=20.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class Sink(http.server.BaseHTTPRequestHandler):
    """Records every POST and PUT: (method, path, body, lower-case headers)."""

    requests: list = []

    def _record(self):
        n = int(self.headers.get("Content-Length", 0))
        self.requests.append((self.command, self.path, self.rfile.read(n),
                              {k.lower(): v for k, v in self.headers.items()}))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    do_POST = do_PUT = _record

    def log_message(self, *_a):
        pass


def signed(body: bytes, head: dict, secret: str) -> bool:
    return verify_signature(body, {"X-ChrysEdge-Auth": head.get("x-chrysedge-auth", ""),
                                   "X-Chrys-Date": head.get("x-chrys-date", ""),
                                   "Content-MD5": head.get("content-md5", "")}, secret)


@pytest.fixture(scope="module")
def sink():
    Sink.requests = []
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_port}", Sink.requests
    httpd.shutdown()
    httpd.server_close()


def _twin_variables():
    """tiny_yolov8's flax init in float32 with randomised BatchNorm terms and
    the class prior zeroed (so NMS sees real candidates, without ties), as
    numpy: the weights of both packages' servers."""
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(0)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(val, path + (k,)) for k, val in node.items()}
        if path[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if path[-1] == "mean" or (path[-1] == "bias" and "bn" in path):
            return rng.normal(0.0, 0.2, node.shape).astype(np.float32)
        return np.asarray(node, np.float32)
    return jax.tree_util.tree_map(np.asarray, jchecksum.zero_class_prior(walk(v, ())))


@pytest.fixture(scope="module")
def variables():
    return _twin_variables()


def _shm():
    import tempfile

    return tempfile.mkdtemp(prefix="vep_srv_", dir="/dev/shm" if os.path.isdir("/dev/shm")
                            else None)


def _config(shm_dir, sink_url, **engine):
    cfg = Config()
    cfg.bus.shm_dir = shm_dir
    cfg.annotation.endpoint = sink_url + "/api/v1/annotate"
    cfg.annotation.poll_duration_ms = 50
    cfg.api.endpoint = sink_url
    cfg.worker_adoption = False   # workers die with the server
    cfg.engine.model = "tiny_yolov8"
    cfg.engine.tick_ms = 20
    cfg.engine.batch_buckets = (1, 2, 4)
    cfg.engine.dtype = "float32"
    for k, v in engine.items():
        setattr(cfg.engine, k, v)
    return cfg


def _port_server(data_dir, sink_url, variables):
    """The port's engine server on the twin weights, started; (server, its
    ring directory)."""
    shm = _shm()
    srv = Server(_config(shm, sink_url), data_dir=data_dir, grpc_port=0, rest_port=0,
                 enable_engine=True, device="cpu")
    srv.engine.warmup()
    srv.engine._model.load_state_dict(from_flax(variables))
    srv.start()
    return srv, shm


def _jax_server(data, variables):
    """The JAX package's Server on the CPU with the port's settings and the
    same weights (a checkpoint of ``variables``); its uplink fails fast. The
    JAX registry builds ``tiny_yolov8`` in bfloat16 and its engine has no
    dtype switch, so while it runs its entry builds the float32 model, as
    the port's server runs it. Its engine compiles the program of the twin
    camera's geometry here, as the port's server warms its engine: an XLA
    compile inside a timed request would outlast the worker heartbeat's
    freshness on a loaded machine. (server, the registry patch to undo, its
    ring directory)."""
    import dataclasses

    from video_edge_ai_proxy_tpu.models import registry as jregistry
    from video_edge_ai_proxy_tpu.serve.server import Server as JaxServer

    patch = pytest.MonkeyPatch()
    patch.setitem(jregistry._REGISTRY, "tiny_yolov8", dataclasses.replace(
        jregistry.get("tiny_yolov8"),
        build=lambda: jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)))
    save_msgpack(os.path.join(data, "tiny_yolov8.msgpack"), variables)
    cfg = JaxConfig()
    cfg.bus.shm_dir = shm = _shm()
    cfg.annotation.endpoint = "http://127.0.0.1:1/annotate"
    cfg.worker_adoption = False
    cfg.engine.model = "tiny_yolov8"
    cfg.engine.tick_ms = 20
    cfg.engine.batch_buckets = (1, 2, 4)
    cfg.engine.dtype = "float32"
    cfg.engine.checkpoint_path = os.path.join(data, "tiny_yolov8.msgpack")
    srv = JaxServer(cfg, data_dir=data, grpc_port=0, rest_port=0, enable_engine=True)
    srv.start()
    srv.engine.compile_for(TWIN_HW, 1)
    return srv, patch, shm


@pytest.fixture(scope="module")
def server(tmp_path_factory, sink, variables):
    import shutil

    srv, shm = _port_server(str(tmp_path_factory.mktemp("srv")), sink[0], variables)
    yield srv
    srv.stop()
    shutil.rmtree(shm, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_server(tmp_path_factory, variables):
    """``_jax_server`` for the module."""
    import shutil

    srv, patch, shm = _jax_server(str(tmp_path_factory.mktemp("jax_srv")), variables)
    yield srv
    srv.stop()
    patch.undo()
    shutil.rmtree(shm, ignore_errors=True)


@pytest.fixture(scope="module")
def stub(server):
    channel = grpc.insecure_channel(f"127.0.0.1:{server.bound_grpc_port}")
    yield pb_grpc.ImageStub(channel), channel
    channel.close()


def rest(server, path, body=None, method=None):
    url = f"http://127.0.0.1:{server._rest.bound_port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method or ("POST" if data else "GET"),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        raw = resp.read()
        return resp.status, (json.loads(raw) if raw and raw[:1] in b"[{" else raw)


def rest_error(server, path, body=None, method=None) -> int:
    with pytest.raises(urllib.error.HTTPError) as err:
        rest(server, path, body, method)
    return err.value.code


def test_rest_process_crud_and_log_follow(server):
    assert rest(server, "/api/v1/settings", {"edge_key": "k", "edge_secret": "s"})[0] == 200
    assert rest(server, "/api/v1/settings")[1]["edge_key"] == "k"
    assert rest(server, "/api/v1/process", {"name": "crud", "rtsp_endpoint": synth_url(5),
                                            "annotation_policy": "keyframe"})[0] == 200
    assert rest_error(server, "/api/v1/process", {"name": "crud",
                                                  "rtsp_endpoint": synth_url()}) == 409
    assert rest_error(server, "/api/v1/process", {"name": "x"}) == 400
    assert rest_error(server, "/api/v1/process", {"name": "x", "rtsp_endpoint": "a",
                                                  "annotation_policy": "oops"}) == 400
    assert "crud" in [p["name"] for p in rest(server, "/api/v1/processlist")[1]]
    assert wait_for(lambda: rest(server, "/api/v1/process/crud")[1].get("source")
                    == "synthetic")
    info = rest(server, "/api/v1/process/crud")[1]
    assert info["annotation_policy"] == "keyframe" and info["state"]["running"]
    assert info["limits"]["mem_limit_mb"] == 2048
    assert wait_for(lambda: rest(server, "/api/v1/process/crud/logs?since=0")[1]["lines"])
    first = rest(server, "/api/v1/process/crud/logs?since=0")[1]
    # The bounded source's reconnect lines keep the log growing.
    assert wait_for(lambda: rest(server, f"/api/v1/process/crud/logs?since={first['total']}")
                    [1]["lines"])
    assert rest_error(server, "/api/v1/process/ghost/logs") == 400
    assert rest_error(server, "/api/v1/process/crud/logs?since=x") == 400
    assert rest(server, "/api/v1/process/crud", method="DELETE")[0] == 200
    assert rest_error(server, "/api/v1/process/crud", method="DELETE") == 409
    assert "crud" not in [p["name"] for p in rest(server, "/api/v1/processlist")[1]]


TWIN = {"name": "twin", "rtsp_endpoint": synth_url(1, w=64, h=48), "annotation_policy": "keyframe"}
TWIN_HW = (48, 64)
# A one-frame worker writes its heartbeat once, after its frame; the
# servers report it for 5 s (STATUS_FRESH_MS), so the answers that carry it
# are taken as soon as it shows.
HEARTBEAT_WAIT_S = 60.0
RESULT_WAIT_S = 60.0
# The families the engine, the process manager and the uplink register.
ENGINE_FAMILY_PREFIXES = ("vep_engine_", "vep_stream_", "vep_device_batch", "vep_batch_",
                          "vep_frames_late", "vep_step_cache_", "vep_drain_", "vep_subscriber_",
                          "vep_worker", "vep_annotation", "vep_ladder_", "vep_model_")


@pytest.fixture(scope="module")
def twins(server, jax_server):
    """The same requests to the port's server and the JAX one. Each gets
    one camera over REST on a one-frame source (frame 0 of the pattern,
    then EOF), with an Inference subscription opened before the camera
    starts: each engine serves that frame once, to a fresh tracker. Returns
    each server's answers by name."""
    out = {}
    ts = int(time.time() * 1000)
    for tag, srv, mod, mod_grpc in (("port", server, pb, pb_grpc),
                                    ("jax", jax_server, jpb, jpb_grpc)):
        channel = grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}")
        stub = mod_grpc.ImageStub(channel)
        n_subs = len(srv.engine._subscribers)
        call = stub.Inference(mod.InferenceRequest(device_ids=["twin"]), timeout=RESULT_WAIT_S)
        results: list = []
        reader = threading.Thread(target=lambda: results.extend(itertools.islice(call, 1)),
                                  daemon=True)
        reader.start()
        assert wait_for(lambda: len(srv.engine._subscribers) > n_subs), \
            f"{tag}: the Inference subscription did not reach the engine"
        got = out[tag] = {
            "POST settings": rest(srv, "/api/v1/settings", {"edge_key": "k", "edge_secret": "s"}),
            "POST process": rest(srv, "/api/v1/process", TWIN),
            "POST process again": rest_error(srv, "/api/v1/process", TWIN),
            "POST process without endpoint": rest_error(srv, "/api/v1/process", {"name": "x"}),
            "POST process bad policy": rest_error(srv, "/api/v1/process", {
                "name": "x", "rtsp_endpoint": "a", "annotation_policy": "oops"}),
            "logs of no process": rest_error(srv, "/api/v1/process/ghost/logs"),
            "logs bad cursor": rest_error(srv, "/api/v1/process/twin/logs?since=x"),
            "GET process of none": rest_error(srv, "/api/v1/process/ghost"),
        }
        seen: dict = {}

        def heartbeat_shows_the_frame():
            seen["GET process"] = rest(srv, "/api/v1/process/twin")
            return (seen["GET process"][1].get("heartbeat") or {}).get("published") == 1

        assert wait_for(heartbeat_shows_the_frame, timeout=HEARTBEAT_WAIT_S), \
            f"{tag}: no fresh worker heartbeat with published == 1 within {HEARTBEAT_WAIT_S} s"
        got.update({
            "GET process": seen["GET process"],
            "GET processlist": rest(srv, "/api/v1/processlist"),
            "ListStreams": [s for s in stub.ListStreams(mod.ListStreamRequest())
                            if s.name == "twin"],
        })
        reader.join(timeout=RESULT_WAIT_S)
        call.cancel()
        assert results, f"{tag}: no Inference result for the one frame within {RESULT_WAIT_S} s"
        with pytest.raises(grpc.RpcError) as err:
            next(iter(stub.Inference(mod.InferenceRequest(model="yolov8m_typo"), timeout=10)))
        def ask():
            for _ in range(80):
                yield mod.VideoFrameRequest(device_id="twin")
                time.sleep(0.02)
        got.update({
            "VideoLatestImage": next(iter(stub.VideoLatestImage(ask(), timeout=30))),
            "Annotate": stub.Annotate(mod.AnnotateRequest(
                device_name="twin", type="parked", start_timestamp=ts, confidence=0.5)),
            "Inference unknown model": err.value.code(),
            "result": results[0],
            "GET settings": rest(srv, "/api/v1/settings"),
            "GET logs": rest(srv, "/api/v1/process/twin/logs?since=0"),
        })
        channel.close()
    return out


# Values that differ from run to run (pids, clocks, a clock-window rate).
VOLATILE = {"container_id", "pid", "created", "modified", "ts_ms", "fps"}


def _stable(obj):
    """A REST answer with its run-dependent values replaced by their type
    name, and a log tail by its keys; every key and every other value stays.
    The log lines are held apart (``_worker_up``): the two packages' workers
    format their lines differently."""
    if isinstance(obj, dict):
        return {k: (type(v).__name__ if k in VOLATILE else sorted(v) if k == "logs"
                    else _stable(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_stable(v) for v in obj]
    return obj


def _worker_up(lines):
    return [line[line.index("ingest worker up:"):] for line in lines
            if "ingest worker up:" in line]


def test_rest_answers_equal_jax(twins):
    port, jax_ = twins["port"], twins["jax"]
    for name in ("POST settings", "POST process", "POST process again",
                 "POST process without endpoint", "POST process bad policy",
                 "logs of no process", "logs bad cursor", "GET process", "GET processlist",
                 "GET settings", "GET process of none"):
        assert _stable(port[name]) == _stable(jax_[name]), name
    assert port["GET process"][1]["heartbeat"]["published"] == 1
    assert port["GET settings"][1]["edge_key"] == "k"
    status, logs = port["GET logs"]
    assert (status, sorted(logs)) == (jax_["GET logs"][0], sorted(jax_["GET logs"][1]))
    assert _worker_up(logs["lines"]) == _worker_up(jax_["GET logs"][1]["lines"]) != []


def test_list_streams_equal_jax(twins):
    def fields(streams):
        return [{f.name: v for f, v in s.ListFields() if f.name != "pid"} for s in streams]

    port, jax_ = twins["port"]["ListStreams"], twins["jax"]["ListStreams"]
    assert fields(port) == fields(jax_) != []
    assert [s.pid > 0 for s in port] == [s.pid > 0 for s in jax_] == [True]


def test_video_frame_and_annotate_answers_equal_jax(twins):
    def wire(msg, skip=()):
        """The message's bytes on the wire, without the fields in ``skip``."""
        msg = type(msg).FromString(msg.SerializeToString())
        for name in skip:
            msg.ClearField(name)
        return msg.SerializeToString(deterministic=True)

    port, jax_ = twins["port"], twins["jax"]
    frame = port["VideoLatestImage"]
    assert wire(frame, ["timestamp"]) == wire(jax_["VideoLatestImage"], ["timestamp"])
    assert (frame.width, frame.height, len(frame.data), frame.trace_id != 0) == \
        (64, 48, 64 * 48 * 3, True)
    assert wire(port["Annotate"]) == wire(jax_["Annotate"])
    assert port["Annotate"].type == "parked"


def test_inference_result_equals_jax(twins):
    """One frame through both engines and out of both wires: every field,
    the timestamps and latency apart; confidences within 1e-5 and boxes
    within 1 px (float32 on both, from the same weights)."""
    got, want = twins["port"]["result"], twins["jax"]["result"]
    for name in ("device_id", "model", "model_version", "batch_size", "frame_packet",
                 "trace_id", "parent_span"):
        assert getattr(got, name) == getattr(want, name), name
    assert want.trace_id != 0 and got.timestamp > 0 and want.timestamp > 0
    assert len(got.detections) == len(want.detections) > 0
    for a, b in zip(got.detections, want.detections):
        assert (a.class_id, a.class_name, a.track_id, list(a.embedding)) == \
            (b.class_id, b.class_name, b.track_id, list(b.embedding))
        assert a.track_id and a.HasField("box") and b.HasField("box")
        for k in ("top", "left", "width", "height"):
            assert abs(getattr(a.box, k) - getattr(b.box, k)) <= 1, k
        assert abs(a.confidence - b.confidence) <= 1e-5
    assert twins["port"]["Inference unknown model"] == twins["jax"]["Inference unknown model"] \
        == grpc.StatusCode.INVALID_ARGUMENT


def test_rest_delete_equal_jax(server, jax_server, twins):
    answers = []
    for srv in (server, jax_server):
        answers.append([rest(srv, "/api/v1/process/twin", method="DELETE"),
                        rest_error(srv, "/api/v1/process/twin", method="DELETE"),
                        rest(srv, "/api/v1/processlist")])
    assert answers[0] == answers[1] == [(200, b""), 409, (200, [])]


class _FakeClock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _StubTracer:
    """A device tracer that writes the bundle's trace as the port's
    torch.profiler tracer names it and advances the fake clocks."""

    def __init__(self, *clocks):
        self.clocks = clocks

    def __call__(self, log_dir, ms):
        for clk in self.clocks:
            clk.advance(ms / 1000.0)
        name = os.path.basename(os.path.dirname(log_dir))
        with open(os.path.join(log_dir, f"{name}.trace.json"), "w") as f:
            json.dump({"traceEvents": []}, f)


def _planes_answers(srv, channel):
    """The audit and profiling routes' answers of one server, over REST
    and the admin RPCs, with run-dependent values (wall stamps, paths)
    dropped."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if k not in ("ts", "path", "dir")}
        if isinstance(obj, (list, tuple)):
            return [strip(v) for v in obj]
        return obj

    def call(path, method=None):
        try:
            return strip(rest(srv, path, method=method))
        except urllib.error.HTTPError as err:
            return err.code

    def admin(name, body):
        try:
            return strip(json.loads(channel.unary_unary(f"/vep.Admin/{name}")(body)))
        except grpc.RpcError as err:
            return err.code()

    out = {path: call(path) for path in (
        "/api/v1/journal", "/api/v1/journal?actor=ladder", "/api/v1/journal?subject=slo:lat",
        "/api/v1/journal?subject=ladder", "/api/v1/journal?since=1",
        "/api/v1/journal?limit=1", "/api/v1/journal?since=x",
        "/api/v1/why?subject=ladder:engine", "/api/v1/why?stream=nope", "/api/v1/why",
        "/api/v1/why?stream=a&max_links=x",
        "/api/v1/trace?stream=parity", "/api/v1/trace?stream=parity&format=chrome",
        "/api/v1/trace?limit=x",
        "/api/v1/profile?ms=0", "/api/v1/profile?ms=x", "/api/v1/profile?ms=20000")}
    out["POST profile"] = call("/api/v1/profile?ms=50", method="POST")
    out["GET profile"] = call("/api/v1/profile?ms=40")
    out["stop not running"] = call("/api/v1/profile/stop", method="POST")
    out["admin capture"] = admin("ProfileCapture", b'{"ms": 30}')
    out["admin bad"] = [admin("ProfileCapture", b) for b in (b'{"ms": 0}', b"not json")]
    prof = srv.engine.prof
    if prof is not None:
        prof._acquire("capture")
        try:
            out["busy"] = [call("/api/v1/profile?ms=50", method="POST"),
                           call("/api/v1/profile/start", method="POST"),
                           admin("ProfileCapture", b'{"ms": 50}')]
        finally:
            prof._release()
    obs = rest(srv, "/api/v1/stats")[1]["obs"]
    out["stats"] = strip({k: obs[k] for k in ("journal", "prof")})
    if obs["prof"] is not None:
        out["stats"]["prof"].pop("retained_bytes")   # each manifest holds its path
    out["quality canary"] = admin("Quality", b"").get("canary", "absent") \
        if srv.engine.quality is not None else None
    return out


def test_audit_and_profiling_routes_equal_jax(server, jax_server, tmp_path):
    """The journal, why, trace and profile routes and the admin
    ProfileCapture of both packages' servers on the same plane state: a
    journal of the same events on one fake clock, the same lineage spans,
    a profiler on fake clocks with a stub device tracer; then the journal
    and the profiler switched off (400 and FAILED_PRECONDITION)."""
    from video_edge_ai_proxy_tpu.obs import journal as jjournal
    from video_edge_ai_proxy_tpu.obs import prof as jprof
    from video_edge_ai_proxy_tpu.obs import spans as jspans
    from video_edge_ai_proxy_tpu_torch.obs import journal, prof, spans

    answers = {}
    for tag, srv, jmod, pmod, smod in (("port", server, journal, prof, spans),
                                       ("jax", jax_server, jjournal, jprof, jspans)):
        eng = srv.engine
        saved = (eng.journal, eng.prof, smod.tracer.enabled, smod.tracer.sample_every)
        clk, mono = _FakeClock(1.7e9), _FakeClock(100.0)
        eng.journal = jmod.DecisionJournal(64, clock=clk)
        s1 = eng.journal.record("slo", "episode_open", subject=("slo", "lat"),
                                trigger={"fast": 2.0, "slow": 1.5, "threshold": 1.2})
        eng.journal.record("ladder", "escalate", subject=("ladder", "engine"),
                           trigger={"from": "normal", "to": "shed"}, cause=s1)
        eng.prof = pmod.Profiler(str(tmp_path / tag[0]), clock=mono, wall_clock=clk,
                                 sleep=lambda s: None, device_tracer=_StubTracer(mono, clk),
                                 journal=eng.journal, snapshot_fn=lambda: {"fixed": 1})
        smod.tracer.configure(enabled=True, sample_every=1)
        smod.tracer.record("parity", "collect", 7, ts=1000.005, pub_ms=1000000.0)
        smod.tracer.record("parity", "device", 7, ts=1000.011, dur_ms=4.0, bucket=2)
        smod.tracer.record("parity", "emit", 7, ts=1000.0115)
        channel = grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}")
        try:
            on = _planes_answers(srv, channel)
            eng.journal, eng.prof = None, None
            off = _planes_answers(srv, channel)
        finally:
            channel.close()
            eng.journal, eng.prof = saved[0], saved[1]
            smod.tracer.configure(enabled=saved[2], sample_every=saved[3])
        answers[tag] = (on, off)
    for state in (0, 1):
        port, jax_ = answers["port"][state], answers["jax"][state]
        for key in port:
            assert port[key] == jax_[key], (state, key)
    on, off = answers["port"]
    assert on["POST profile"][0] == 200 and on["POST profile"][1]["error"] is None
    assert on["POST profile"][1]["journal_events"] == 2
    assert on["busy"][:2] == [409, 409] and on["busy"][2] == grpc.StatusCode.ABORTED
    assert on["/api/v1/why?subject=ladder:engine"][1]["links"] == 2
    assert on["/api/v1/trace?stream=parity"][1]["breakdown"]["device"]["count"] == 1
    assert on["/api/v1/profile?ms=20000"] == 400 and on["stop not running"] == 409
    assert off["/api/v1/journal"] == off["POST profile"] == 400
    assert off["admin capture"] == grpc.StatusCode.FAILED_PRECONDITION


def test_grpc_frames_streams_and_toggles(server, stub, sink):
    stub, _ = stub
    server.settings.overwrite("edgekey", "edgesecret")
    server.process_manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    server.process_manager.start(StreamProcess(
        name="stor", rtsp_endpoint=synth_url(), rtmp_endpoint="rtmp://cloud/live/streamKey9"))
    assert wait_for(lambda: any(s.name == "cam1" and s.running and s.source == "synthetic"
                                for s in stub.ListStreams(pb.ListStreamRequest())))

    def fetch_one():
        def gen():
            for _ in range(80):
                yield pb.VideoFrameRequest(device_id="cam1")
                time.sleep(0.02)
        for frame in stub.VideoLatestImage(gen(), timeout=30):
            return frame
        return None

    f1, f2 = fetch_one(), fetch_one()          # per-connection cursors
    assert f1 is not None and f2 is not None
    assert (f1.width, f1.height, len(f1.data)) == (32, 24, 32 * 24 * 3)
    assert [(d.name, d.size) for d in f1.shape.dim] == [("height", 24), ("width", 32),
                                                        ("channels", 3)]
    ts = int(time.time() * 1000)
    resp = stub.Annotate(pb.AnnotateRequest(device_name="cam1", type="moving",
                                            start_timestamp=ts, confidence=0.5))
    assert resp.device_name == "cam1" and resp.type == "moving"
    with pytest.raises(grpc.RpcError) as err:
        stub.Annotate(pb.AnnotateRequest(device_name="cam1", type="x", start_timestamp=1))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT

    def posted_moving():
        for method, path, body, head in list(sink[1]):
            if method == "POST" and any(e["type"] == "moving" for e in json.loads(body)):
                return body, head
        return None

    assert wait_for(lambda: posted_moving() is not None, timeout=30)
    body, head = posted_moving()
    (event,) = [e for e in json.loads(body) if e["type"] == "moving"]
    assert event["start_timestamp"] == ts and event["confidence"] == 0.5
    assert signed(body, head, "edgesecret")
    assert stub.Proxy(pb.ProxyRequest(device_id="cam1", passthrough=True)).passthrough
    assert server.bus.proxy_rtmp("cam1")
    with pytest.raises(grpc.RpcError) as err:
        stub.Proxy(pb.ProxyRequest(device_id="ghost", passthrough=True))
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as err:
        stub.Storage(pb.StorageRequest(device_id="cam1", start=True))
    assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert stub.Storage(pb.StorageRequest(device_id="stor", start=True)).start
    (put,) = [r for r in sink[1] if r[0] == "PUT"]
    assert put[1] == "/api/v1/edge/storage/streamKey9" and signed(put[2], put[3], "edgesecret")
    assert server.bus.hget("last_access_time_stor", "store") == "true"
    assert server.process_manager.info("stor").rtmp_stream_status.storing is True
    server.process_manager.stop("stor")
    server.process_manager.stop("cam1")


def test_grpc_inference_and_model_filter(server, stub):
    stub, _ = stub
    server.process_manager.start(StreamProcess(name="inf", rtsp_endpoint=synth_url(w=64, h=48)))
    results = []
    for r in stub.Inference(pb.InferenceRequest(device_ids=["inf"]), timeout=60):
        results.append(r)
        if len(results) >= 3:
            break
    assert len(results) == 3
    for r in results:
        assert r.device_id == "inf" and r.model == "tiny_yolov8" and r.batch_size >= 1
        assert r.model_version == "0" and r.timestamp > 0
        assert all(d.HasField("box") and d.track_id for d in r.detections)
    assert any(r.detections for r in results)
    with pytest.raises(grpc.RpcError) as err:
        for _ in stub.Inference(pb.InferenceRequest(device_ids=["inf"], model="tiny_vit"),
                                timeout=2):
            pass
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    with pytest.raises(grpc.RpcError) as err:
        next(iter(stub.Inference(pb.InferenceRequest(model="yolov8m_typo"), timeout=5)))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert rest(server, "/api/v1/stats")[1]["engine"]["streams"]["inf"]["frames"] >= 3
    # One stream at a time: on a loaded CPU the ladder's admission_pause
    # would pause the later streams of a crowd.
    server.process_manager.stop("inf")


def test_admin_and_observability_routes(server, stub):
    stub, channel = stub
    # The queue's count comes from this test's own event, not from an
    # earlier test of the module (a worker of a distributed run may run
    # this one first).
    if not server.settings.edge_credentials()[0]:
        server.settings.overwrite("k", "s")
    stub.Annotate(pb.AnnotateRequest(device_name="admin", type="admin_check",
                                     start_timestamp=int(time.time() * 1000), confidence=0.5))
    assert json.loads(channel.unary_unary("/vep.Admin/RouterState")(b""))["rung"] in (
        "normal", "shed", "bucket_downshift", "admission_pause")
    quality = json.loads(channel.unary_unary("/vep.Admin/Quality")(b""))
    assert "streams" in quality and quality["canary"] is None
    # The profiler is on by default: a capture on the CPU engine.
    man = json.loads(channel.unary_unary("/vep.Admin/ProfileCapture")(b'{"ms": 100}'))
    assert man["ms"] == 100 and man["error"] is None and man["device_trace"]
    assert man["context"] == {"via": "grpc"}
    status, health = rest(server, "/healthz")
    assert status == 200 and health["engine"]["ok"] and health["status"] == "ok"
    stats = rest(server, "/api/v1/stats")[1]
    assert stats["engine"]["model"] == "tiny_yolov8" and stats["engine"]["prewarm"]["complete"]
    assert stats["annotation_queue"]["published"] >= 1
    assert "slos" in rest(server, "/api/v1/slo")[1]
    assert rest(server, "/api/v1/router")[1]["fleet_attached"] is False
    assert "streams" in rest(server, "/api/v1/quality")[1]
    status, text = rest(server, "/metrics")
    assert b"vep_workers_total" in text and b"vep_annotations_published_total" in text
    req = urllib.request.Request(f"http://127.0.0.1:{server._rest.bound_port}/api/v1/process",
                                 method="OPTIONS")
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.status == 204
        assert resp.headers["Access-Control-Allow-Origin"] == "*"
    assert rest(server, "/api/v1/journal")[1]["next_seq"] >= 1
    # A plane not ported: only the OPTIONS route matches its path.
    assert rest_error(server, "/api/v1/capacity") == 405
    # The cascade's route, with the plane off: the disabled-plane 400.
    assert rest_error(server, "/api/v1/cascade") == 400


def test_killed_worker_restarts_and_serves_again(server, stub):
    stub, _ = stub
    pm = server.process_manager
    pm.start(StreamProcess(name="kill", rtsp_endpoint=synth_url(w=64, h=48)))
    assert wait_for(lambda: pm.info("kill").state.running)
    pid = pm.info("kill").state.pid
    os.kill(pid, signal.SIGKILL)
    assert wait_for(lambda: pm.info("kill").state.running and pm.info("kill").state.pid != pid,
                    timeout=30)
    state = pm.info("kill").state
    assert state.failing_streak == 1 and state.oom_killed
    t_back = time.time() * 1000
    for r in stub.Inference(pb.InferenceRequest(device_ids=["kill"]), timeout=60):
        if r.timestamp >= t_back:
            break
    else:
        pytest.fail("no result after the restart")


def test_readoption_across_two_servers(tmp_path, shm_dir, sink):
    """worker_adoption: stop() detaches, a second server on the same data
    dir re-adopts the live worker (same pid and birth tick) and frames keep
    flowing; shutdown_workers() ends it."""
    cfg = _config(shm_dir, sink[0])
    cfg.worker_adoption = True
    srv = Server(cfg, data_dir=str(tmp_path), grpc_port=0, rest_port=0)
    srv.start()
    srv.process_manager.start(StreamProcess(name="adopt", rtsp_endpoint=synth_url()))
    srv.bus.touch_query("adopt")
    assert wait_for(lambda: srv.bus.read_latest("adopt") is not None)
    rec = srv.process_manager.info("adopt")
    pid, starttime = rec.state.pid, rec.runtime["starttime"]
    srv.stop()
    assert os.path.exists(f"/proc/{pid}")
    srv2 = Server(cfg, data_dir=str(tmp_path), grpc_port=0, rest_port=0)
    try:
        srv2.start()
        rec = srv2.process_manager.info("adopt")
        assert (rec.state.pid, rec.runtime["starttime"]) == (pid, starttime)
        t_adopt = int(time.time() * 1000)
        srv2.bus.touch_query("adopt")
        assert wait_for(lambda: (f := srv2.bus.read_latest("adopt")) is not None
                        and f.meta.timestamp_ms >= t_adopt)
    finally:
        srv2.process_manager.shutdown_workers()
        srv2.stop()
    assert wait_for(lambda: not os.path.exists(f"/proc/{pid}")
                    or open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] == "Z")


BLOCKED = """
import sys
for name in ("grpc", "google", "google.protobuf", "aiohttp", "yaml"):
    sys.modules[name] = None
import video_edge_ai_proxy_tpu_torch.serve.server as server_mod
import video_edge_ai_proxy_tpu_torch.serve.process_manager
import video_edge_ai_proxy_tpu_torch.uplink.queue
import video_edge_ai_proxy_tpu_torch.uplink.cloud
import video_edge_ai_proxy_tpu_torch.proto.annotate
import video_edge_ai_proxy_tpu_torch.obs.journal
import video_edge_ai_proxy_tpu_torch.obs.prof
import video_edge_ai_proxy_tpu_torch.obs.spans
import video_edge_ai_proxy_tpu_torch.obs.watch
from video_edge_ai_proxy_tpu_torch.utils.config import Config, load_config
cfg = load_config(sys.argv[3])
cfg.bus.shm_dir = sys.argv[1]
cfg.worker_adoption = False
srv = server_mod.Server(cfg, data_dir=sys.argv[2], grpc_port=0, rest_port=0)
try:
    srv.start()
except ImportError as exc:
    print("ImportError", exc.name)
else:
    print("started")
finally:
    srv.stop()
# What got imported (the blocked names stay None).
print(sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m.split(".")[0] in ("grpc", "aiohttp", "yaml")
                  or m.startswith("google.protobuf"))))
"""


def test_without_the_wire_packages_the_planes_build_and_start_raises(tmp_path, shm_dir):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED, shm_dir, str(tmp_path / "data"),
         str(tmp_path / "absent.yaml")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "ImportError grpc" and lines[-1] == "[]"


def _families(text: bytes) -> set:
    return {line.split()[2] for line in text.decode().splitlines()
            if line.startswith("# TYPE ")}


def _families_probe(tmp: str) -> None:
    """Run in a fresh interpreter (``test_engine_metric_families_and_drops_equal_jax``):
    both packages' servers on the twin weights, each serving the twin
    camera's one frame to an Inference subscriber, then each one's
    ``/metrics`` families and ``/api/v1/stats`` drops. Its process-wide
    registries hold only what these two servers registered. Prints one
    ``FAMILIES {json}`` line."""
    import shutil

    from video_edge_ai_proxy_tpu_torch.obs import registry as obs_registry

    variables = _twin_variables()
    Sink.requests = []
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    for d in ("srv", "jax_srv"):
        os.makedirs(os.path.join(tmp, d), exist_ok=True)
    port_srv, port_shm = _port_server(os.path.join(tmp, "srv"),
                                      f"http://127.0.0.1:{httpd.server_port}", variables)
    jax_srv, patch, jax_shm = _jax_server(os.path.join(tmp, "jax_srv"), variables)
    out = {}
    try:
        for tag, srv, mod, mod_grpc in (("port", port_srv, pb, pb_grpc),
                                        ("jax", jax_srv, jpb, jpb_grpc)):
            channel = grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}")
            stub = mod_grpc.ImageStub(channel)
            n_subs = len(srv.engine._subscribers)
            call = stub.Inference(mod.InferenceRequest(device_ids=["twin"]),
                                  timeout=RESULT_WAIT_S)
            results: list = []
            reader = threading.Thread(target=lambda: results.extend(itertools.islice(call, 1)),
                                      daemon=True)
            reader.start()
            assert wait_for(lambda: len(srv.engine._subscribers) > n_subs), \
                f"{tag}: the Inference subscription did not reach the engine"
            assert rest(srv, "/api/v1/process", TWIN)[0] == 200
            reader.join(timeout=RESULT_WAIT_S)
            call.cancel()
            channel.close()
            text = rest(srv, "/metrics")[1]
            drops = srv.engine.subscriber_drops
            out[tag] = {
                "results": len(results),
                "families": sorted(_families(text)),
                "stats_drops": rest(srv, "/api/v1/stats")[1]["engine"]["subscriber_drops"],
                "engine_drops": drops,
                "drops_line": f"vep_subscriber_dropped_total {drops}".encode() in text
                or f"vep_subscriber_dropped_total {float(drops)}".encode() in text,
            }
        out["port"]["registry"] = sorted(f.name for f in obs_registry.families())
    finally:
        port_srv.stop()
        jax_srv.stop()
        patch.undo()
        httpd.shutdown()
        httpd.server_close()
        for shm in (port_shm, jax_shm):
            shutil.rmtree(shm, ignore_errors=True)
    print("FAMILIES " + json.dumps(out), flush=True)


FAMILIES_PROBE = ("import sys; sys.path.insert(0, sys.argv[2]); "
                  "import test_torch_server; test_torch_server._families_probe(sys.argv[1])")


def test_engine_metric_families_and_drops_equal_jax(tmp_path):
    """The /metrics families of both servers' engines and control planes
    (the families the JAX server exports for its engine, workers and
    uplink), and the slow-subscriber drops in /api/v1/stats and /metrics.
    Both servers run in a fresh interpreter (``_families_probe``): the
    process-wide registries of a test worker also hold what its other tests
    registered (a JAX test that sets ``vep_engine_feature_disabled``), which
    neither server registers."""
    proc = subprocess.run(
        [sys.executable, "-c", FAMILIES_PROBE, str(tmp_path), os.path.join(ROOT, "tests")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("FAMILIES ")]
    assert line, proc.stdout[-3000:]
    port, jax_ = (json.loads(line[-1][len("FAMILIES "):])[k] for k in ("port", "jax"))
    assert port["results"] == jax_["results"] == 1
    mine, theirs = set(port["families"]), set(jax_["families"])
    shared = {f for f in theirs if f.startswith(ENGINE_FAMILY_PREFIXES)}
    # A labelled family shows once it has a child (a stream, a model).
    assert {"vep_engine_ticks_total", "vep_batch_occupancy_pct",
            "vep_subscriber_dropped_total"} <= shared
    assert shared - mine == set()
    assert {"vep_engine_ticks_total", "vep_device_batch_ms", "vep_batch_occupancy_pct",
            "vep_frames_late_total", "vep_stream_subscriber_dropped_total"} <= \
        set(port["registry"])
    assert port["stats_drops"] == port["engine_drops"]
    assert isinstance(jax_["stats_drops"], int)
    assert port["drops_line"]


def test_a_stopped_server_leaves_its_engine_collectable(tmp_path):
    """Once a Server that answered REST requests has stopped, nothing of the
    process keeps its engine (and the device memory behind it) alive:
    aiohttp's process-wide cache of built middleware chains held every
    handler it served, and the handlers close over the engine."""
    import gc
    import shutil
    import weakref

    shm = _shm()
    srv = Server(_config(shm, "http://127.0.0.1:1"), data_dir=str(tmp_path / "data"),
                 grpc_port=0, rest_port=0, enable_engine=True, device="cpu")
    srv.start()
    try:
        for path in ("/api/v1/stats", "/api/v1/processlist", "/healthz"):
            assert rest(srv, path)[0] == 200
    finally:
        srv.stop()
        shutil.rmtree(shm, ignore_errors=True)
    engine = weakref.ref(srv.engine)
    del srv
    gc.collect()
    assert engine() is None


def test_a_cleaned_up_rest_app_leaves_its_engine_collectable():
    """The same through ``build_app`` on aiohttp's test server (as the card
    smoke reads ``/api/v1/hbm``): once the app is cleaned up, the engine its
    handlers served is collectable."""
    import asyncio
    import gc
    import weakref

    from aiohttp.test_utils import TestClient, TestServer

    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.serve.rest_api import build_app
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", hbm=True),
                             device="cpu")

    async def ask():
        async with TestClient(TestServer(build_app(None, None, engine=engine))) as client:
            return (await client.get("/api/v1/hbm")).status

    assert asyncio.run(ask()) == 200
    ref = weakref.ref(engine)
    del engine
    gc.collect()
    assert ref() is None


def test_redis_backend_server_answers_equal_jax(tmp_path, sink):
    """``bus.backend: redis``: the port's ``Server`` on the port's MiniRedis
    beside the JAX ``Server`` on the JAX package's, neither with an engine.
    Each registers the one-frame camera over REST; its worker publishes to
    Redis, and the same requests get the same answers: the process record,
    ``ListStreams``, the frame ``VideoLatestImage`` reads back through
    ``XREVRANGE``, ``Annotate`` queued in Redis (the rmq ready list, the
    Redis annotation queue's), ``Proxy`` written to the camera's hash. The
    Redis keys both leave are the same."""
    import shutil

    from video_edge_ai_proxy_tpu.bus.miniredis import MiniRedis as JMiniRedis
    from video_edge_ai_proxy_tpu.serve.server import Server as JaxServer
    from video_edge_ai_proxy_tpu_torch.bus.miniredis import MiniRedis
    from video_edge_ai_proxy_tpu_torch.bus.resp import RespClient
    from video_edge_ai_proxy_tpu_torch.uplink.redis_queue import RedisAnnotationQueue

    cam = {"name": "rtwin", "rtsp_endpoint": synth_url(1, w=64, h=48)}
    ts = int(time.time() * 1000)
    got = {}
    for tag, redis_cls, server_cls, cfg_cls, mod, mod_grpc in (
            ("port", MiniRedis, Server, Config, pb, pb_grpc),
            ("jax", JMiniRedis, JaxServer, JaxConfig, jpb, jpb_grpc)):
        redis = redis_cls()
        cfg = cfg_cls()
        cfg.bus.backend = "redis"
        cfg.bus.redis_addr = redis.addr
        cfg.bus.shm_dir = shm = _shm()
        cfg.annotation.endpoint = sink[0] + "/api/v1/annotate"
        cfg.annotation.poll_duration_ms = 60_000      # the events stay queued in Redis
        cfg.worker_adoption = False
        srv = server_cls(cfg, data_dir=str(tmp_path / tag), grpc_port=0, rest_port=0)
        srv.start()
        channel = grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}")
        try:
            stub = mod_grpc.ImageStub(channel)
            out = got[tag] = {
                "POST settings": rest(srv, "/api/v1/settings", {"edge_key": "k",
                                                                 "edge_secret": "s"}),
                "POST process": rest(srv, "/api/v1/process", cam)}
            seen = {}

            def published():
                seen["GET process"] = rest(srv, "/api/v1/process/rtwin")
                return (seen["GET process"][1].get("heartbeat") or {}).get("published") == 1

            assert wait_for(published, timeout=HEARTBEAT_WAIT_S), tag

            def ask():
                for _ in range(80):
                    yield mod.VideoFrameRequest(device_id="rtwin")
                    time.sleep(0.02)

            out.update({
                "GET process": seen["GET process"],
                "ListStreams": [{f.name: v for f, v in s.ListFields() if f.name != "pid"}
                                for s in stub.ListStreams(mod.ListStreamRequest())],
                "frame": next(iter(stub.VideoLatestImage(ask(), timeout=30))),
                "Annotate": stub.Annotate(mod.AnnotateRequest(
                    device_name="rtwin", type="parked", start_timestamp=ts, confidence=0.5)),
                "Proxy": stub.Proxy(mod.ProxyRequest(device_id="rtwin", passthrough=True)),
                "annotations": type(srv.annotations).__name__,
                "bus": type(srv.bus).__name__,
            })
            raw = RespClient.from_addr(redis.addr)
            out["keys"] = sorted(k for k in raw.command("KEYS", "*")
                                 if not k.startswith(b"rmq::connection::"))
            out["ready"] = raw.command("LRANGE", "rmq::queue::[annotationqueue]::ready", "0",
                                       "-1")
            out["hash"] = sorted(raw.command("HKEYS", "last_access_time_rtwin"))
            out["proxy"] = raw.command("HGET", "last_access_time_rtwin", "proxy_rtmp")
            raw.close()
        finally:
            channel.close()
            srv.stop()
            redis.close()
            shutil.rmtree(shm, ignore_errors=True)
    port, jax_ = got["port"], got["jax"]
    assert port["annotations"] == jax_["annotations"] == RedisAnnotationQueue.__name__
    assert port["bus"] == jax_["bus"] == "RedisFrameBus"
    for name in ("POST settings", "POST process", "GET process"):
        assert _stable(port[name]) == _stable(jax_[name]), name
    assert port["ListStreams"] == jax_["ListStreams"] != []
    for name in ("frame", "Annotate", "Proxy"):
        a, b = (type(m).FromString(m.SerializeToString()) for m in (port[name], jax_[name]))
        if name == "frame":
            a.ClearField("timestamp")
            b.ClearField("timestamp")
        assert a.SerializeToString(deterministic=True) == \
            b.SerializeToString(deterministic=True), name
    assert (port["frame"].width, port["frame"].height) == (64, 48)
    assert port["keys"] == jax_["keys"] and b"rtwin" in port["keys"]
    assert port["hash"] == jax_["hash"] and port["proxy"] == jax_["proxy"] == b"true"
    assert len(port["ready"]) == len(jax_["ready"]) == 1
    assert port["ready"] == jax_["ready"]

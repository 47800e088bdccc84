"""The port's annotation uplink against the JAX package's: the
``AnnotateRequest`` codec (``proto/annotate.py``) against protobuf's own
serializer, the cloud-event mapping, the signed batch POST, and the
queue's, the spool's and the breaker's behaviour on the same inputs."""

import http.server
import json
import math
import random
import struct
import threading
import urllib.error

import pytest
from hypothesis import example, given, settings, strategies as st

from video_edge_ai_proxy_tpu.proto import pb
from video_edge_ai_proxy_tpu.resilience import CircuitBreaker as JaxBreaker
from video_edge_ai_proxy_tpu.resilience import DeadLetterSpool as JaxSpool
from video_edge_ai_proxy_tpu.resilience import RetryPolicy as JaxRetry
from video_edge_ai_proxy_tpu.uplink import AnnotationQueue as JaxQueue
from video_edge_ai_proxy_tpu.uplink import annotation_to_cloud as jax_to_cloud
from video_edge_ai_proxy_tpu.uplink import cloud as jax_cloud
from video_edge_ai_proxy_tpu.utils.signing import verify_signature
from video_edge_ai_proxy_tpu_torch.proto import annotate
from video_edge_ai_proxy_tpu_torch.resilience import CircuitBreaker, DeadLetterSpool, RetryPolicy
from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue, annotation_to_cloud
from video_edge_ai_proxy_tpu_torch.uplink import cloud as torch_cloud

INT32 = st.integers(-(2 ** 31), 2 ** 31 - 1)
INT64 = st.integers(-(2 ** 63), 2 ** 63 - 1)
# Every bit pattern a double can hold: -0.0, NaN payloads, infinities.
DOUBLE = st.one_of(st.floats(allow_nan=True, allow_infinity=True),
                   st.sampled_from([0.0, -0.0, float("nan"), float("inf"), 5e-324]))
TEXT = st.text(max_size=12)
BOX = st.builds(annotate.BoundingBox, top=INT32, left=INT32, width=INT32, height=INT32)
LOC = st.builds(annotate.Location, lat=DOUBLE, lon=DOUBLE)
COORD = st.builds(annotate.Coordinate, x=DOUBLE, y=DOUBLE, z=DOUBLE)
REQUEST = st.builds(
    annotate.AnnotateRequest,
    device_name=TEXT, remote_stream_id=TEXT, type=TEXT,
    start_timestamp=INT64, end_timestamp=INT64, object_type=TEXT, object_id=TEXT,
    object_tracking_id=TEXT, confidence=DOUBLE,
    object_bouding_box=st.none() | BOX, location=st.none() | LOC,
    object_coordinate=st.none() | COORD, mask=st.lists(COORD, max_size=3),
    object_signature=st.lists(DOUBLE, max_size=5), ml_model=TEXT, ml_model_version=TEXT,
    width=INT32, height=INT32, is_keyframe=st.booleans(), video_type=TEXT,
    offset_timestamp=INT64, offset_duration=INT64, offset_frame_id=INT64,
    offset_packet_id=INT64, custom_meta_1=TEXT, custom_meta_2=TEXT, custom_meta_3=TEXT,
    custom_meta_4=TEXT, custom_meta_5=TEXT,
)
SETTINGS = settings(max_examples=150, deadline=None, database=None, derandomize=True)

# The traps: a packed repeated double, a negative int64 (10-byte varint),
# defaults not written, -0.0 and NaN written, field-number order.
TRAPS = [
    annotate.AnnotateRequest(object_signature=[0.0, -0.0, float("nan"), 1.5]),
    annotate.AnnotateRequest(start_timestamp=-1, width=-7, offset_packet_id=-(2 ** 63)),
    annotate.AnnotateRequest(device_name="", confidence=0.0, is_keyframe=False, width=0),
    annotate.AnnotateRequest(confidence=-0.0, location=annotate.Location(lat=float("nan"))),
    annotate.AnnotateRequest(custom_meta_5="z", device_name="a", mask=[annotate.Coordinate()],
                             object_bouding_box=annotate.BoundingBox(), ml_model="m"),
]


def to_pb(req: annotate.AnnotateRequest) -> pb.AnnotateRequest:
    out = pb.AnnotateRequest()
    for name, value in vars(req).items():
        if isinstance(value, list):
            if name == "mask":
                out.mask.extend(pb.Coordinate(x=c.x, y=c.y, z=c.z) for c in value)
            else:
                getattr(out, name).extend(value)
        elif value is None:
            continue
        elif hasattr(value, "__dataclass_fields__"):
            getattr(out, name).SetInParent()
            for k, v in vars(value).items():
                setattr(getattr(out, name), k, v)
        else:
            setattr(out, name, value)
    return out


def bits(v: float) -> bytes:
    return struct.pack("<d", v)


def same_fields(got: annotate.AnnotateRequest, msg: pb.AnnotateRequest) -> None:
    """Field by field; doubles compared by their bits (NaN, -0.0)."""
    for name, value in vars(got).items():
        if name == "mask":
            assert [(bits(c.x), bits(c.y), bits(c.z)) for c in value] == \
                [(bits(c.x), bits(c.y), bits(c.z)) for c in msg.mask]
        elif name == "object_signature":
            assert [bits(v) for v in value] == [bits(v) for v in msg.object_signature]
        elif name in ("object_bouding_box", "location", "object_coordinate"):
            assert (value is not None) == msg.HasField(name), name
            if value is not None:
                for k, v in vars(value).items():
                    w = getattr(getattr(msg, name), k)
                    assert (bits(v) == bits(w)) if isinstance(v, float) else v == w, (name, k)
        elif isinstance(value, float):
            assert bits(value) == bits(getattr(msg, name)), name
        else:
            assert value == getattr(msg, name), name


@pytest.mark.parametrize("req", TRAPS, ids=["packed", "negative", "defaults", "nan_negzero",
                                             "order"])
def test_codec_traps_byte_identical(req):
    want = to_pb(req).SerializeToString()
    assert annotate.encode(req) == want
    same_fields(annotate.decode(want), pb.AnnotateRequest.FromString(want))


@SETTINGS
@given(REQUEST)
@example(TRAPS[0])
@example(TRAPS[1])
def test_codec_equals_protobuf(req):
    msg = to_pb(req)
    raw = msg.SerializeToString()
    assert annotate.encode(req) == raw
    same_fields(annotate.decode(raw), msg)


def test_decode_reads_any_valid_encoding():
    """Unknown fields skipped, a repeated scalar keeps the last value, a
    repeated nested message merges, field 14 unpacked: as protobuf reads."""
    raw = (pb.AnnotateRequest(device_name="a", object_bouding_box=pb.BoundingBox(top=1))
           .SerializeToString()
           + b"\xf8\x07\x05"                        # field 127, varint: unknown
           + pb.AnnotateRequest(device_name="b", object_bouding_box=pb.BoundingBox(left=2))
           .SerializeToString()
           + b"\x71" + struct.pack("<d", 2.5))       # field 14, one unpacked double
    msg = pb.AnnotateRequest.FromString(raw)
    same_fields(annotate.decode(raw), msg)
    assert msg.device_name == "b" and msg.object_bouding_box.top == 1
    with pytest.raises(annotate.DecodeError):
        annotate.decode(b"\x0a\x05ab")               # length past the end


@SETTINGS
@given(REQUEST)
def test_annotation_to_cloud_equals_jax(req):
    got = json.dumps(annotation_to_cloud(req), sort_keys=True)
    want = json.dumps(jax_to_cloud(to_pb(req)), sort_keys=True)
    assert got == want


# -- the signed POST -----------------------------------------------------------


class _Capture(http.server.BaseHTTPRequestHandler):
    posts: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.posts.append((self.path, self.rfile.read(n), {k.lower(): v for k, v in
                                                           self.headers.items()}))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *_a):
        pass


class FakeSettings:
    def edge_credentials(self):
        return "ekey", "esecret"


def test_batch_handler_posts_the_jax_packages_signed_json():
    posts = []
    handler_cls = type("Capture", (_Capture,), {"posts": posts})
    httpd = http.server.HTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/api/v1/annotate"
        batch = [to_pb(r).SerializeToString() for r in TRAPS[1:]] + [
            pb.AnnotateRequest(device_name=f"cam{i}", type="detection", start_timestamp=i,
                               confidence=0.5, object_bouding_box=pb.BoundingBox(top=i),
                               object_signature=[0.25] * i).SerializeToString()
            for i in range(3)]
        assert torch_cloud.make_batch_handler(FakeSettings(), url)(batch) is True
        assert jax_cloud.make_batch_handler(FakeSettings(), url)(batch) is True
    finally:
        httpd.shutdown()
        httpd.server_close()
    (p_path, p_body, p_head), (j_path, j_body, j_head) = posts
    assert p_path == j_path == "/api/v1/annotate"
    assert p_body == j_body                           # the same JSON, byte for byte
    assert p_head["content-md5"] == j_head["content-md5"]
    for head, body in ((p_head, p_body), (j_head, j_body)):
        canon = {"X-ChrysEdge-Auth": head["x-chrysedge-auth"],
                 "X-Chrys-Date": head["x-chrys-date"], "Content-MD5": head["content-md5"]}
        assert verify_signature(body, canon, "esecret")
        assert canon["X-ChrysEdge-Auth"].startswith("ekey:")


# -- queue, spool and breaker: the same scenario through both packages -----------


PACKAGES = {
    "jax": dict(queue=JaxQueue, spool=JaxSpool, retry=JaxRetry, breaker=JaxBreaker,
                cloud=jax_cloud),
    "torch": dict(queue=AnnotationQueue, spool=DeadLetterSpool, retry=RetryPolicy,
                  breaker=CircuitBreaker, cloud=torch_cloud),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_queue_batches_requeues_and_sheds(pkg):
    batches = []
    q = pkg["queue"](lambda b: batches.append(b) or True, max_batch_size=3)
    for i in range(7):
        q.publish(bytes([i]))
    while q.drain_once():
        pass
    assert [len(b) for b in batches] == [3, 3, 1] and q.acked == 7
    fail = {"on": True}
    seen = []

    def handler(batch):
        if fail["on"]:
            return False
        seen.extend(batch)
        return True

    q = pkg["queue"](handler, max_batch_size=10)
    for i in range(4):
        q.publish(bytes([i]))
    assert q.drain_once() == 0 and q.depth() == 4
    fail["on"] = False
    q.requeue_rejected()
    assert q.drain_once() == 4 and seen == [bytes([i]) for i in range(4)]
    q = pkg["queue"](lambda b: True, unacked_limit=5)
    assert [q.publish(b"x") for _ in range(8)] == [True] * 5 + [False] * 3
    assert q.dropped == 3

    def boom(batch):
        raise RuntimeError("down")

    q = pkg["queue"](boom)
    q.publish(b"x")
    assert q.drain_once() == 0 and q.depth() == 1


class _ScriptedCloud:
    """'ok' delivers, 'down' raises URLError, '403' ForbiddenError; the last
    entry repeats."""

    def __init__(self, script, forbidden):
        self.script = list(script)
        self.forbidden = forbidden
        self.posts = 0
        self.batches = []

    def post_annotations(self, url, annotations, deadline=None):
        step = self.script[min(self.posts, len(self.script) - 1)]
        self.posts += 1
        if step == "down":
            raise urllib.error.URLError("scripted outage")
        if step == "403":
            raise self.forbidden("scripted 403")
        self.batches.append(list(annotations))
        return b"{}"


def _handler(pkg, cloud, spool=None):
    return pkg["cloud"].make_batch_handler(
        None, "test://annotate", client=cloud, spool=spool,
        retry=pkg["retry"](max_attempts=2, base_s=0.001, cap_s=0.002, rng=random.Random(0),
                           sleep=lambda s: None),
        breaker=pkg["breaker"]("uplink_test", failure_threshold=2, recovery_timeout_s=0.0))


def _batch(tag, n=2):
    return [annotate.encode(annotate.AnnotateRequest(device_name=f"{tag}-cam{i}",
                                                     type="moving", start_timestamp=i))
            for i in range(n)]


def test_outage_spools_then_drains_exactly_once(pkg, tmp_path):
    cloud = _ScriptedCloud(["down"], pkg["cloud"].ForbiddenError)
    spool = pkg["spool"](str(tmp_path))
    handler = _handler(pkg, cloud, spool)
    for tag in ("b0", "b1", "b2"):
        assert handler(_batch(tag)) is True          # spooled == acked
    assert spool.pending() == 3 and cloud.batches == []
    assert handler.breaker.state == "open"
    cloud.script = ["ok"]
    assert handler(_batch("b3")) is True
    assert spool.pending() == 0
    names = [e["device_name"] for b in cloud.batches for e in b]
    assert sorted(names) == sorted(f"b{i}-cam{j}" for i in range(4) for j in range(2))
    assert [b[0]["device_name"] for b in cloud.batches] == [
        "b3-cam0", "b0-cam0", "b1-cam0", "b2-cam0"]
    assert handler(_batch("x")) is True
    assert _handler(pkg, _ScriptedCloud(["down"], None), None)(_batch("y")) is False


def test_forbidden_disables_and_keeps_the_breaker_closed(pkg, tmp_path):
    cloud = _ScriptedCloud(["403"], pkg["cloud"].ForbiddenError)
    spool = pkg["spool"](str(tmp_path))
    handler = _handler(pkg, cloud, spool)
    assert handler(_batch("a")) is True
    assert handler.state["disabled"] is True and spool.pending() == 0
    posts = cloud.posts
    assert handler(_batch("b")) is True and cloud.posts == posts
    assert handler.breaker.state == "closed"


def test_spool_salvages_a_torn_batch(pkg, tmp_path):
    spool = pkg["spool"](str(tmp_path))
    spool.put([b"aa", b"bbb", b"cccc"])
    (path,) = [p for p in (tmp_path).iterdir() if p.suffix == ".batch"]
    path.write_bytes(path.read_bytes()[:-2])          # tear the last item
    got = []
    assert spool.drain(lambda items: got.append(items) or True) == 1
    assert got == [[b"aa", b"bbb"]]
    assert (spool.truncated_batches, spool.dropped_events) == (1, 1)


def test_breaker_half_opens_on_an_injected_clock(pkg):
    now = [0.0]
    br = pkg["breaker"]("t", failure_threshold=2, recovery_timeout_s=5.0, clock=lambda: now[0])
    for _ in range(2):
        br.record_failure()
    assert br.state == "open" and not br.allow()
    now[0] = 5.0
    assert br.allow() and br.state == "half_open" and not br.allow()
    br.record_success()
    assert br.state == "closed" and br.transitions == {"open": 1, "half_open": 1, "closed": 1}
    assert math.isclose(br.time_in_open_s(), 0.0)

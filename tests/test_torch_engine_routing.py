"""Per-stream model routing and the annotation half of the port's engine,
against the JAX package's.

- The collector's per-stream models and the ``inference_model: "none"``
  gate group, skip and keep hot exactly the streams the JAX collector
  does; the engine picks each stream's model, falls back from an unknown
  one to the default, and its failure breaker half-opens and recovers (the
  counterparts of ``tests/test_engine.py``'s routing tests); one program
  per (model, geometry, bucket), stable across ticks.
- The four emit policies (and an unknown one, and the per-stream
  override) decide as the JAX ``_should_annotate`` does over one sequence
  of host detections, and the bytes put on the queue equal the JAX
  engine's ``AnnotateRequest.SerializeToString()``, quality events too.
- On one replay trace, in float32 with ``from_flax`` weights on
  ``tiny_yolov8``, the engine's decoded annotation stream equals the JAX
  engine's emit logic (its detections, tracker and ``_annotate``) applied
  to the JAX serving step's outputs on the same batches: the same count
  and classes per stream, boxes within 1 px, confidences within 2e-4.
"""

import functools
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JaxBus
from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.proto import pb
from video_edge_ai_proxy_tpu.replay import checksum as jchecksum
from video_edge_ai_proxy_tpu.uplink import AnnotationQueue as JaxQueue
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JaxEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import runner
from video_edge_ai_proxy_tpu_torch.engine.collector import Collector
from video_edge_ai_proxy_tpu_torch.engine.runner import BoundingBox, Detection, InferenceEngine
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
from video_edge_ai_proxy_tpu_torch.proto import annotate
from video_edge_ai_proxy_tpu_torch.replay import checksum, player, recorder
from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


def _meta(w=64, h=64, ts=None, key=True, packet=0):
    return FrameMeta(width=w, height=h, channels=3, packet=packet, is_keyframe=key,
                     timestamp_ms=ts or int(time.time() * 1000))


def _publish(bus, device_id, w=64, h=64, value=128, **kw):
    return bus.publish(device_id, np.full((h, w, 3), value, np.uint8), _meta(w, h, **kw))


def _sink():
    return AnnotationQueue(handler=lambda batch: True)


def _engine(bus, model="tiny_yolov8", **kw):
    cfg_kw = dict(model=model, batch_buckets=(1, 2, 4), tick_ms=5, dtype="float32")
    cfg_kw.update({k: kw.pop(k) for k in list(kw) if hasattr(EngineConfig, k)})
    cfg = EngineConfig(**cfg_kw)
    kw.setdefault("annotations", _sink())
    return InferenceEngine(bus, cfg, device="cpu", **kw)


def _groups(groups):
    return sorted((g.model, tuple(g.device_ids), g.bucket, tuple(g.src_hw)) for g in groups)


# -- the collector: per-stream models and the "none" gate --------------------------


def test_collector_groups_and_gates_like_jax():
    """Four streams over three models and one switched off, on both
    packages' collectors, for three ticks (first sight, then the pooled
    fast path, then the assembly window)."""
    assign = {"a": None, "b": ("tiny_vit", 0), "c": ("tiny_vit", 0), "d": ("none", 0),
              "e": ("tiny_videomae", 2)}
    model_of = assign.get
    pbus, jbus = MemoryFrameBus(), JaxBus()
    pcol = Collector(pbus, buckets=(1, 2, 4), default_model="tiny_yolov8", model_of=model_of)
    jcol = jcollector.Collector(jbus, buckets=(1, 2, 4), default_model="tiny_yolov8",
                                model_of=model_of)
    for did in assign:
        for b in (pbus, jbus):
            b.create_stream(did, 48 * 64 * 3)
    for tick in range(3):
        for i, did in enumerate(assign):
            for b in (pbus, jbus):
                b.publish(did, np.full((48, 64, 3), 10 * i + tick, np.uint8),
                          _meta(64, 48, packet=tick))
        assert pcol.keep_streams_hot(now_ms=777 + tick) == \
            jcol.keep_streams_hot(now_ms=777 + tick) == ["a", "b", "c", "e"]
        assert pbus.last_query_ms("d") is None
        if tick == 2:
            pcol.plan_assembly()
            pcol.assemble_step()
        got, want = pcol.collect(), jcol.collect()
        assert _groups(got) == _groups(want)
        for g in got:
            (w,) = [x for x in want if x.model == g.model and x.device_ids == g.device_ids]
            np.testing.assert_array_equal(g.frames, w.frames)
    # The clip model's stream sampled one 2-frame clip per tick from tick 2.
    assert any(g.model == "tiny_videomae" and g.frames.shape[1] == 2 for g in got)


def test_engine_selects_each_streams_model():
    assignments = {"cam_detect": "", "cam_cls": "tiny_vit"}
    bus = MemoryFrameBus()
    eng = _engine(bus, model_resolver=lambda d: assignments.get(d, ""))
    eng.warmup()
    for did in assignments:
        bus.create_stream(did, 64 * 64 * 3)
        _publish(bus, did)
    by_model = {g.model: g for g in eng._collector.collect()}
    assert set(by_model) == {"tiny_yolov8", "tiny_vit"}
    assert by_model["tiny_vit"].device_ids == ["cam_cls"]
    out_det = eng._step((64, 64), 1, "tiny_yolov8")(torch.from_numpy(by_model["tiny_yolov8"].frames))
    out_cls = eng._step((64, 64), 1, "tiny_vit")(torch.from_numpy(by_model["tiny_vit"].frames))
    assert "valid" in out_det and "top_probs" in out_cls
    assert eng._models["tiny_vit"][0].kind == "classify"


def test_unknown_model_falls_back_to_default():
    bus = MemoryFrameBus()
    eng = _engine(bus, model_resolver=lambda d: "nope")
    eng.warmup()
    bus.create_stream("cam1", 32 * 32 * 3)
    _publish(bus, "cam1", w=32, h=32)
    (group,) = eng._collector.collect()
    assert group.model == "tiny_yolov8"
    assert eng._bad_models["nope"]["failures"] == 1
    assert "KeyError" in eng._bad_models["nope"]["error"]


def test_bad_model_breaker_half_opens_and_recovers():
    eng = _engine(MemoryFrameBus(), model_resolver=lambda d: "tiny_vit")
    fail = {"n": 0}
    real = eng._ensure_model

    def flaky(name):
        if fail["n"] < 2:
            fail["n"] += 1
            raise RuntimeError("transient OOM")
        return real(name)

    eng._ensure_model = flaky
    assert eng._stream_model("cam1") is None
    bad = eng._bad_models["tiny_vit"]
    assert bad["failures"] == 1 and "transient OOM" in bad["error"]
    assert bad["retry_at"] - time.monotonic() <= InferenceEngine.BAD_MODEL_BACKOFF_S
    assert eng._stream_model("cam1") is None and fail["n"] == 1      # open: no retry
    assert eng.health()["disabled_models"]["tiny_vit"]["failures"] == 1
    eng._bad_models["tiny_vit"]["retry_at"] = 0.0
    assert eng._stream_model("cam1") is None
    bad = eng._bad_models["tiny_vit"]
    assert bad["failures"] == 2
    assert bad["retry_at"] - time.monotonic() > InferenceEngine.BAD_MODEL_BACKOFF_S   # doubled
    eng._bad_models["tiny_vit"]["retry_at"] = 0.0
    assert eng._stream_model("cam1") == ("tiny_vit", 0)
    assert eng._bad_models == {} and eng.health()["disabled_models"] == {}


def test_multi_model_step_cache_is_one_program_per_key_and_stable():
    assign = {"f0": "", "f1": "", "f2": "tiny_vit", "f3": "tiny_vit", "f4": "tiny_videomae",
              "f5": "tiny_videomae"}
    bus = MemoryFrameBus()
    eng = _engine(bus, model_resolver=lambda d: assign.get(d, ""), batch_buckets=(1, 2))
    eng.warmup()
    for did in assign:
        bus.create_stream(did, 64 * 64 * 3)

    def tick():
        for did in assign:
            _publish(bus, did)
        groups = eng._collector.collect()
        for g in groups:
            out = eng._step(g.src_hw, g.bucket, g.model)(torch.from_numpy(np.array(g.frames)))
            assert all(torch.isfinite(v.float()).all() for v in out.values())
        return groups

    for _ in range(4):            # tiny_videomae's clip is 4 frames
        groups = tick()
    assert sorted(g.model for g in groups) == ["tiny_videomae", "tiny_vit", "tiny_yolov8"]
    keys = sorted(eng._steps)
    assert [k[0] for k in keys] == ["tiny_videomae", "tiny_vit", "tiny_yolov8"]
    for _ in range(3):
        tick()
    assert sorted(eng._steps) == keys


def test_engine_serves_routed_streams_with_annotations():
    """start(): a default stream, a tiny_vit stream, a stream switched off
    and a keyframe-policy stream; one subscriber. Results carry their
    model, the switched-off stream has none; the uplink gets detection and
    classify events, none from the switched-off stream, and only keyframe
    events from the keyframe stream."""
    models = {"det": "", "cls": "tiny_vit", "off": "none", "kf": ""}
    policies = {"kf": "keyframe", "det": "all"}
    queued = []
    ann = AnnotationQueue(handler=lambda b: True)
    ann.publish = lambda payload: queued.append(annotate.decode(payload)) or True
    bus = MemoryFrameBus()
    eng = _engine(bus, model_resolver=lambda d: models[d],
                  annotation_policy_resolver=lambda d: policies.get(d, ""), annotations=ann)
    eng.warmup()
    eng._model.load_state_dict(checksum.zero_class_prior(eng._model.state_dict()))
    for did in models:
        bus.create_stream(did, 64 * 64 * 3)
    got: dict = {}
    results = eng.subscribe(timeout=0.1)
    reader = threading.Thread(target=lambda: [got.setdefault(r.device_id, []).append(r)
                                              for r in results], daemon=True)
    reader.start()
    eng.start()
    try:
        deadline = time.monotonic() + 60
        n = 0
        while time.monotonic() < deadline and not all(
                len(got.get(d, [])) >= 4 for d in ("det", "cls", "kf")):
            for i, did in enumerate(models):
                _publish(bus, did, value=(37 * n + 11 * i) % 256, key=n % 3 == 0, packet=n)
            n += 1
            time.sleep(0.02)
    finally:
        eng.stop()
    reader.join(10)
    assert not reader.is_alive()
    assert "off" not in got
    assert {r.model for r in got["det"]} == {"tiny_yolov8"}
    assert {r.model for r in got["cls"]} == {"tiny_vit"}
    assert all(len(r.detections) == 5 and r.detections[0].box == BoundingBox()
               for r in got["cls"])
    assert all(d.track_id for r in got["det"] for d in r.detections)
    by_stream: dict = {}
    for req in queued:
        by_stream.setdefault(req.device_name, []).append(req)
    assert "off" not in by_stream
    assert {r.type for r in by_stream["det"]} == {"detection"}
    assert all(r.object_bouding_box is not None and r.object_tracking_id and
               r.ml_model == "tiny_yolov8" for r in by_stream["det"])
    assert {r.type for r in by_stream["cls"]} == {"classify"}
    assert all(r.object_bouding_box is None for r in by_stream["cls"])
    assert all(r.is_keyframe for r in by_stream.get("kf", []))
    assert eng._stream_interest("anything")      # the uplink: standing interest


# -- emit policies against the JAX engine's decisions --------------------------------


def _namespace(cls, cfg, queue, resolver):
    ns = types.SimpleNamespace(
        _annotations=queue, _cfg=cfg, _ann_policy_resolver=resolver,
        _state_lock=threading.Lock(), _ann_state={}, _ann_policy_warned=set(),
        annotations_suppressed=0, _spec=types.SimpleNamespace(name="tiny_yolov8", kind="detect"))
    ns._should_annotate = functools.partial(cls._should_annotate, ns)
    return ns


def _detection_sequence(rng, frames=60):
    """Per frame: (timestamp, keyframe?, [(track, class, conf, box)]) with
    objects coming and going and confidences drifting."""
    seq, dets = [], []
    for f in range(frames):
        if rng.uniform() < 0.3:         # the scene changes
            dets = [(str(int(rng.integers(1, 5))) if rng.uniform() < 0.8 else "",
                     int(rng.integers(0, 3)), float(np.round(rng.uniform(0.0, 1.0), 3)),
                     tuple(int(v) for v in rng.integers(-5, 300, 4)))
                    for _ in range(int(rng.integers(0, 4)))]
        else:                           # the same objects, confidences drift
            dets = [(t, k, float(np.round(min(1.0, max(0.0, c + rng.normal(0, 0.08))), 3)), b)
                    for t, k, c, b in dets]
        seq.append((1000 + 300 * f + int(rng.integers(0, 40)), f % 5 == 0, dets))
    return seq


@pytest.mark.parametrize("policy", ["all", "keyframe", "min_interval", "on_change", "bogus",
                                    "override"])
def test_emit_policy_decisions_and_bytes_equal_jax(policy):
    rng = np.random.default_rng(5)
    seq = _detection_sequence(rng)
    default = "on_change" if policy == "override" else policy
    resolver = (lambda d: "all" if d == "cam1" else "") if policy == "override" else None
    kw = dict(annotation_emit=default, annotation_min_interval_ms=700,
              annotation_confidence_delta=0.15)
    pq, jq = [], []
    pns = _namespace(InferenceEngine, EngineConfig(**kw),
                     types.SimpleNamespace(publish=pq.append), resolver)
    jns = _namespace(jrunner.InferenceEngine, JaxEngineConfig(**kw),
                     types.SimpleNamespace(publish=jq.append), resolver)
    for ts, key, dets in seq:
        for stream in ("cam0", "cam1"):
            meta = _meta(640, 480, ts=ts, key=key)
            pd = [Detection(box=BoundingBox(left=b[0], top=b[1], width=b[2], height=b[3]),
                            confidence=c, class_id=k, class_name=f"c{k}", track_id=t)
                  for t, k, c, b in dets]
            jd = [pb.Detection(box=pb.BoundingBox(left=b[0], top=b[1], width=b[2], height=b[3]),
                               confidence=c, class_id=k, class_name=f"c{k}", track_id=t)
                  for t, k, c, b in dets]
            before = (len(pq), len(jq))
            InferenceEngine._annotate(pns, stream, meta, pd)
            jrunner.InferenceEngine._annotate(jns, stream, meta, jd)
            assert len(pq) - before[0] == len(jq) - before[1]
    assert pq == jq                               # the same wire bytes, in order
    assert pns.annotations_suppressed == jns.annotations_suppressed
    assert pns._ann_state.keys() == jns._ann_state.keys()
    if policy in ("keyframe", "min_interval", "on_change"):
        assert 0 < len(pq) and pns.annotations_suppressed > 0


def test_an_overloaded_queue_sheds_by_arrival_as_jax():
    """The uplink under overload, in both packages: four streams emit in
    stream order each tick, three events a frame, into a queue that holds 9
    and acks 4 a tick. The queue sheds by arrival, so the streams emitted
    first take every slot that frees, and cam3, paused after three ticks
    (as the ladder's admission_pause pauses the later streams), offers 9
    events and delivers none, in the port as in the JAX package."""
    def counting(queue, decode, counts):
        def publish(payload):
            ok = queue.publish(payload)
            counts.setdefault(decode(payload).device_name, [0, 0])[0 if ok else 1] += 1
            return ok
        return types.SimpleNamespace(publish=publish)

    kw = dict(annotation_emit="all")
    pq = AnnotationQueue(handler=lambda batch: True, max_batch_size=4, unacked_limit=9)
    jq = JaxQueue(handler=lambda batch: True, max_batch_size=4, unacked_limit=9)
    pcounts, jcounts = {}, {}
    pns = _namespace(InferenceEngine, EngineConfig(**kw),
                     counting(pq, annotate.decode, pcounts), None)
    jns = _namespace(jrunner.InferenceEngine, JaxEngineConfig(**kw),
                     counting(jq, pb.AnnotateRequest.FromString, jcounts), None)
    objects = [(str(t), t % 3, 0.5 + 0.1 * t, (10 * t, 5, 20, 20)) for t in range(1, 4)]
    for tick in range(8):
        for stream in ("cam0", "cam1", "cam2", "cam3")[:4 if tick < 3 else 3]:
            meta = _meta(640, 480, ts=1000 + 33 * tick, key=tick == 0)
            InferenceEngine._annotate(pns, stream, meta, [
                Detection(box=BoundingBox(left=b[0], top=b[1], width=b[2], height=b[3]),
                          confidence=c, class_id=k, class_name=f"c{k}", track_id=t)
                for t, k, c, b in objects])
            jrunner.InferenceEngine._annotate(jns, stream, meta, [
                pb.Detection(box=pb.BoundingBox(left=b[0], top=b[1], width=b[2], height=b[3]),
                             confidence=c, class_id=k, class_name=f"c{k}", track_id=t)
                for t, k, c, b in objects])
        assert pq.drain_once() == jq.drain_once()
    assert pcounts == jcounts
    assert pcounts["cam3"] == [0, 9] and pcounts["cam0"][0] > pcounts["cam2"][0]
    assert (pq.published, pq.acked, pq.dropped) == (jq.published, jq.acked, jq.dropped)


def test_quality_transition_event_equals_jax(monkeypatch):
    monkeypatch.setattr(runner.time, "time", lambda: 1_700_000_000.5)
    monkeypatch.setattr(jrunner.time, "time", lambda: 1_700_000_000.5)
    pq, jq = [], []
    pns = types.SimpleNamespace(_annotations=types.SimpleNamespace(publish=pq.append))
    jns = types.SimpleNamespace(_annotations=types.SimpleNamespace(publish=jq.append))
    for old, new in (("ok", "black"), ("black", "ok"), ("ok", "frozen")):
        InferenceEngine._on_quality_transition(pns, "cam3", old, new)
        jrunner.InferenceEngine._on_quality_transition(jns, "cam3", old, new)
    assert pq == jq and len(pq) == 3
    assert annotate.decode(pq[0]).type == "quality"
    none = types.SimpleNamespace(_annotations=None)
    InferenceEngine._on_quality_transition(none, "cam3", "ok", "black")   # no uplink: no-op


# -- one replay trace: the engine's annotation stream against the JAX emit --------------


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("routing") / "ann.vtrace"
    return recorder.record_synthetic_trace(str(path), ["cam0", "cam1", "cam2"], width=128,
                                           height=96, fps=30.0, frames=6)


@pytest.fixture(scope="module")
def variables():
    """tiny_yolov8's flax init with randomised BatchNorm terms, the class
    prior zeroed (so NMS sees real candidates), as numpy."""
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray,
                               jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
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


def test_replay_annotation_stream_equals_jax(trace_path, variables):
    queued = []
    ann = AnnotationQueue(handler=lambda b: True)
    ann.publish = lambda payload: queued.append(payload) or True
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", dtype="float32",
                                                         prefetch=False),
                          device="cpu", annotations=ann)
    eng._model = eng._spec.init_params(device="cpu", dtype=torch.float32)
    eng._model.load_state_dict(from_flax(variables))
    batches = []
    emit = eng._emit

    def recording(inflight):
        g = inflight.group
        batches.append((list(g.device_ids), list(g.metas), np.array(g.frames)))
        emit(inflight)

    eng._emit = recording
    by_packet: dict = {}
    for dev, frame, meta in player.TracePlayer(trace_path).iter_frames():
        by_packet.setdefault(meta.packet, []).append((dev, frame, meta))
    eng.serve_lockstep(by_packet[p] for p in sorted(by_packet))

    # The JAX engine's emit logic on the JAX serving step's outputs.
    jspec = jregistry.get("tiny_yolov8")
    net = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    step = jax.jit(jrunner.build_serving_step(net, jspec))
    jq = []
    jns = _namespace(jrunner.InferenceEngine, JaxEngineConfig(),
                     types.SimpleNamespace(publish=jq.append), None)
    jns.__dict__.update(_conf_threshold=0.0, _trackers={}, _spec=jspec,
                        _num_classes=lambda spec=None: net.cfg.num_classes)
    for ids, metas, frames in batches:
        host = {k: np.asarray(v) for k, v in step(variables, jnp.asarray(frames)).items()}
        for i, (did, meta) in enumerate(zip(ids, metas)):
            dets = jrunner.InferenceEngine._to_detections(jns, host, i, jspec)
            jrunner.InferenceEngine._assign_tracks(jns, did, jspec.name, dets)
            jrunner.InferenceEngine._annotate(jns, did, meta, dets, jspec)

    def streams(events):
        out: dict = {}
        for e in events:
            out.setdefault(e.device_name, []).append(e)
        return out

    got = streams(annotate.decode(b) for b in queued)
    want = streams(pb.AnnotateRequest.FromString(b) for b in jq)
    assert sorted(got) == sorted(want) == ["cam0", "cam1", "cam2"]
    for did in want:
        g, w = got[did], want[did]
        assert len(g) == len(w) > 0
        assert [e.object_type for e in g] == [e.object_type for e in w]
        for a, b in zip(g, w):
            assert abs(a.confidence - b.confidence) <= 2e-4
            box_a, box_b = a.object_bouding_box, b.object_bouding_box
            for k in ("top", "left", "width", "height"):
                assert abs(getattr(box_a, k) - getattr(box_b, k)) <= 1, (did, k)
            assert (a.type, a.ml_model, a.width, a.height, a.is_keyframe) == \
                (b.type, b.ml_model, b.width, b.height, b.is_keyframe)

"""The ``embed`` kind and the engine repairs of the port, against the JAX
package's engine.

- Slow-subscriber drops are counted as ``tests/test_engine.py``'s
  ``test_subscriber_drops_counted`` pins them, through both engines: three
  results into a full subscriber queue give 3 drops, ``{"cam1": 2, "cam2":
  1}``, and ``vep_stream_subscriber_dropped_total`` per stream.
- An ``embed`` row of a step's outputs becomes the same detection in both
  engines (confidence 1, class id -1, the feature vector), and its
  annotation the same ``AnnotateRequest`` bytes (the vector in
  ``object_signature``, no box).
- A mixed engine, ``tiny_yolov8`` by default with ``tiny_resnet`` and
  ``tiny_vit`` streams, hand-stepped (collect, dispatch, drain) in both
  packages on the same weights in float32 and the same frames (each
  stream's scene held still over the ticks, so every track matches its own
  box again at IoU 1 and no near-tie of two float32 programs can reorder
  the trackers' greedy association; both trackers read one clock that
  advances a frame's 33 ms a tick, as a wall clock would tick if XLA's
  first compiles inside the sequence did not outlast the trackers' 10 s
  ``max_gap_s``): the same results, field by field
  (latency and timestamps of the emit apart): boxes within 1 px,
  confidences and embeddings within 2e-4, track ids, classes, batch
  sizes, models.
- The engine families the JAX engine registers on every engine, with the
  late-frame counter over ``obs_late_ms`` and the batch occupancy.
"""

import dataclasses
import queue
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np

from video_edge_ai_proxy_tpu.bus.interface import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.engine import tracker as jtracker
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import resnet as jresnet
from video_edge_ai_proxy_tpu.models import vit as jvit
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.obs import registry as jobs_registry
from video_edge_ai_proxy_tpu.parallel.sharding import unbox
from video_edge_ai_proxy_tpu.proto import pb
from video_edge_ai_proxy_tpu.replay.checksum import zero_class_prior as jzero_class_prior
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import runner, tracker
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, InferenceResult
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
from video_edge_ai_proxy_tpu_torch.obs import registry as obs_registry
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

TOL = 2e-4
# tiny_yolov8's input size: no letterbox padding, whose flat rows give
# anchors of equal scores that two float32 programs may order either way.
HW = (64, 64)
# Streams of the mixed engine and the model each resolves to ("" = the
# default, tiny_yolov8).
MIXED = {"det0": "", "det1": "", "emb0": "tiny_resnet", "emb1": "tiny_resnet",
         "emb2": "tiny_resnet", "cls0": "tiny_vit"}
F32_BUILDS = {
    "tiny_yolov8": lambda: jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32),
    "tiny_resnet": lambda: jresnet.ResNet(jresnet.tiny_resnet_config(), dtype=jnp.float32),
    "tiny_vit": lambda: jvit.ViT(jvit.tiny_vit_config(), dtype=jnp.float32),
}


def test_subscriber_drops_counted_as_jax():
    """The sequence of JAX's test_subscriber_drops_counted, through both
    engines."""
    counts = []
    for eng, result in (
            (InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_mobilenet_v2",
                                                            batch_buckets=(1,), tick_ms=5),
                             device="cpu"), InferenceResult),
            (jrunner.InferenceEngine(JMemoryFrameBus(), JEngineConfig(
                model="tiny_mobilenet_v2", batch_buckets=(1,), tick_ms=5)),
             pb.InferenceResult)):
        full_q: queue.Queue = queue.Queue(maxsize=1)
        full_q.put_nowait("occupied")
        with eng._sub_lock:
            eng._subscribers.append((full_q, None))
        before = {s: _sample("vep_stream_subscriber_dropped_total", eng, s)
                  for s in ("cam1", "cam2")}
        for device_id in ("cam1", "cam1", "cam2"):
            eng._publish(result(device_id=device_id))
        counts.append((eng.subscriber_drops, eng.subscriber_drops_by_stream,
                       {s: _sample("vep_stream_subscriber_dropped_total", eng, s) - before[s]
                        for s in before}))
    assert counts[0] == counts[1] == (3, {"cam1": 2, "cam2": 1}, {"cam1": 2, "cam2": 1})


def _sample(family: str, eng, *labels) -> float:
    """A labelled counter's value in the registry of ``eng``'s package."""
    reg = obs_registry if isinstance(eng, InferenceEngine) else jobs_registry
    fam = {f.name: f for f in reg.families()}.get(family)
    return fam.labels(*labels).value if fam is not None else 0.0


def test_embed_detection_and_annotation_equal_jax():
    """One embed row through ``to_detections`` and ``_annotate`` of each
    package: the same detection, the same AnnotateRequest bytes."""
    emb = np.random.default_rng(3).normal(size=(2, 64)).astype(np.float32)
    host = {"embedding": emb}
    mine = runner.to_detections(host, 1, "embed", 0)
    jeng = types.SimpleNamespace(_spec=types.SimpleNamespace(kind="embed", name="tiny_resnet"))
    theirs = jrunner.InferenceEngine._to_detections(jeng, host, 1)
    assert len(mine) == len(theirs) == 1
    assert (mine[0].confidence, mine[0].class_id, mine[0].class_name) == \
        (theirs[0].confidence, theirs[0].class_id, theirs[0].class_name) == (1.0, -1, "")
    assert mine[0].embedding == list(theirs[0].embedding) == [float(v) for v in emb[1]]
    spec = types.SimpleNamespace(kind="embed", name="tiny_resnet")
    pq, jq = [], []
    for cls, q, dets, cfg in ((InferenceEngine, pq, mine, EngineConfig()),
                              (jrunner.InferenceEngine, jq, theirs, JEngineConfig())):
        ns = types.SimpleNamespace(
            _annotations=types.SimpleNamespace(publish=q.append), _cfg=cfg,
            _ann_policy_resolver=None, _state_lock=threading.Lock(), _ann_state={},
            _ann_policy_warned=set(), annotations_suppressed=0, _spec=spec)
        ns._should_annotate = lambda *a, _cls=cls, _ns=ns: _cls._should_annotate(_ns, *a)
        meta_cls = FrameMeta if cls is InferenceEngine else JFrameMeta
        cls._annotate(ns, "emb0", meta_cls(width=64, height=48, timestamp_ms=1234,
                                           is_keyframe=True), dets, spec)
    assert pq == jq and len(pq) == 1
    req = pb.AnnotateRequest.FromString(pq[0])
    assert req.type == "embed" and not req.HasField("object_bouding_box")
    assert list(req.object_signature) == [float(v) for v in emb[1]]


# -- the mixed engine, hand-stepped ------------------------------------------------


def _f32_jax_registry(monkeypatch):
    for name, build in F32_BUILDS.items():
        monkeypatch.setitem(jregistry._REGISTRY, name,
                            dataclasses.replace(jregistry.get(name), build=build))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, unbox(tree))


class _Mixed:
    """One hand-stepped engine of each package, ``tiny_yolov8`` by default
    and the streams of ``MIXED`` on their models, with the JAX engine's
    weights (the class prior zeroed) carried into the port's."""

    def __init__(self):
        base = dict(model="tiny_yolov8", batch_buckets=(1, 2, 4), tick_ms=5, prefetch=False,
                    quality_thumb=8, dtype="float32")
        resolver = lambda d: MIXED.get(d, "")   # noqa: E731
        self.bus, self.jbus = MemoryFrameBus(), JMemoryFrameBus()
        self.eng = InferenceEngine(self.bus, EngineConfig(**base), device="cpu",
                                   model_resolver=resolver)
        self.jeng = jrunner.InferenceEngine(self.jbus, JEngineConfig(**base),
                                            model_resolver=resolver)
        self.subs = []
        for e in (self.eng, self.jeng):
            e.warmup()
            e._drain_q = queue.Queue(maxsize=16)
            q = queue.Queue()
            with e._sub_lock:
                e._subscribers.append((q, None))
            self.subs.append(q)
        spec, model, variables = self.jeng._models["tiny_yolov8"]
        variables = jzero_class_prior(_numpy(variables))
        self.jeng._variables = variables
        self.jeng._models["tiny_yolov8"] = (spec, model, variables)
        self.eng._model.load_state_dict(from_flax(variables))
        for name in ("tiny_resnet", "tiny_vit"):
            _, _, jvars = self.jeng._ensure_model(name)
            self.eng._ensure_model(name)[1].load_state_dict(from_flax(_numpy(jvars)))
        for did in MIXED:
            self.bus.create_stream(did, HW[0] * HW[1] * 3)
            self.jbus.create_stream(did, HW[0] * HW[1] * 3)

    def close(self):
        self.bus.close()
        self.jbus.close()

    def publish(self, tick: int, scenes: dict):
        for did, frame in scenes.items():
            ts = 1_000_000 + 33 * tick
            self.bus.publish(did, frame, FrameMeta(width=HW[1], height=HW[0], packet=tick,
                                                   timestamp_ms=ts, is_keyframe=tick == 0))
            self.jbus.publish(did, frame, JFrameMeta(width=HW[1], height=HW[0], packet=tick,
                                                     timestamp_ms=ts, is_keyframe=tick == 0))

    def tick(self):
        out = []
        for e, q in ((self.eng, self.subs[0]), (self.jeng, self.subs[1])):
            e._dispatch(e._collector.collect(), time.time())
            while True:
                try:
                    inflight = e._drain_q.get_nowait()
                except queue.Empty:
                    break
                try:
                    e._emit(inflight)
                finally:
                    e._collector.release(inflight.group)
                    e._drain_q.task_done()
            results = []
            while not q.empty():
                results.append(q.get_nowait())
            out.append(sorted(results, key=lambda r: r.device_id))
        return out


def _fields(r):
    return (r.device_id, r.model, r.batch_size, r.frame_packet, r.trace_id, r.parent_span,
            r.timestamp, len(r.detections))


def _detection(d):
    return (d.class_id, d.class_name, d.track_id, len(d.embedding))


def test_mixed_engine_results_equal_jax(monkeypatch):
    _f32_jax_registry(monkeypatch)
    clock = types.SimpleNamespace(t=1000.0)
    clock.monotonic = lambda: clock.t
    for mod in (tracker, jtracker):
        monkeypatch.setattr(mod, "time", clock)
    pair = _Mixed()
    rng = np.random.default_rng(11)
    scenes = {did: rng.integers(0, 256, HW + (3,), dtype=np.uint8) for did in MIXED}
    seen = {}
    try:
        for tick in range(3):
            clock.t += 0.033
            pair.publish(tick, scenes)
            mine, theirs = pair.tick()
            assert [_fields(r) for r in mine] == [_fields(r) for r in theirs]
            for a, b in zip(mine, theirs):
                seen.setdefault(a.model, 0)
                seen[a.model] += 1
                assert [_detection(d) for d in a.detections] == \
                    [_detection(d) for d in b.detections], a.device_id
                for da, db in zip(a.detections, b.detections):
                    assert abs(da.confidence - db.confidence) <= TOL
                    for k in ("left", "top", "width", "height"):
                        assert abs(getattr(da.box, k) - getattr(db.box, k)) <= 1, k
                    np.testing.assert_allclose(da.embedding, list(db.embedding), rtol=TOL,
                                               atol=TOL)
        assert seen == {"tiny_yolov8": 6, "tiny_resnet": 9, "tiny_vit": 3}
        emb = [r for r in mine if r.model == "tiny_resnet"]
        assert all(len(r.detections) == 1 and len(r.detections[0].embedding) == 128
                   and r.detections[0].class_id == -1 for r in emb)
        assert any(r.detections for r in mine if r.model == "tiny_yolov8")
        assert all(d.track_id for r in mine if r.model == "tiny_yolov8" for d in r.detections)
        # The quality plane saw every stream of every kind.
        assert set(pair.eng.quality.snapshot()["streams"]) == \
            set(pair.jeng.quality.snapshot()["streams"]) == set(MIXED)
    finally:
        pair.close()


def test_engine_families_late_and_occupancy():
    """The four families of every JAX engine on a port engine: ticks,
    device batch ms by model, batch occupancy, late frames over
    ``obs_late_ms``."""
    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_resnet", batch_buckets=(1, 2, 4),
                                            tick_ms=5, obs_late_ms=50.0, prefetch=False),
                          device="cpu")
    assert EngineConfig().obs_late_ms == JEngineConfig().obs_late_ms == 1000.0
    fams = {f.name: f for f in obs_registry.families()}
    for name in ("vep_engine_ticks_total", "vep_device_batch_ms", "vep_batch_occupancy_pct",
                 "vep_frames_late_total"):
        assert name in fams
    eng.warmup()
    results = eng.subscribe()
    late_before = _sample("vep_frames_late_total", eng, "late")
    ticks_before = fams["vep_engine_ticks_total"].labels().value
    for did, age_ms in (("late", 5_000), ("fresh", 0), ("fresh2", 0)):
        bus.create_stream(did, 32 * 32 * 3)
        bus.publish(did, np.full((32, 32, 3), 90, np.uint8),
                    FrameMeta(width=32, height=32, timestamp_ms=int(time.time() * 1000) - age_ms))
    eng.start()
    try:
        got = {}
        deadline = time.monotonic() + 60
        while len(got) < 3 and time.monotonic() < deadline:
            r = next(results)
            got[r.device_id] = r
        assert set(got) == {"late", "fresh", "fresh2"}, "the engine served the three streams"
    finally:
        eng.stop()
    assert _sample("vep_frames_late_total", eng, "late") - late_before == 1
    assert fams["vep_engine_ticks_total"].labels().value > ticks_before
    assert fams["vep_device_batch_ms"].labels("tiny_resnet").count >= 1
    occ = fams["vep_batch_occupancy_pct"].labels()
    assert occ.count >= 1 and 0 < occ.sum <= 100.0 * occ.count

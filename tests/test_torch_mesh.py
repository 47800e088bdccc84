"""The port's data-parallel mesh serving (``parallel/mesh.py``,
``parallel/sharding.py``, the sharded collector, the engine on a dp mesh of
device slots, ``ShardedTrackStatePool``, the per-slot accounting and the
mesh-keyed prewarm manifest) held against the JAX package's mesh engine.

JAX serves on the conftest's 8 virtual CPU devices; the port on N slots of
``cpu`` (each slot steps its own rows; on the card, slots of ``cuda:0``).
The same seeded inputs go through both:

- ``factor_mesh`` shapes for 1-8 devices, ``make_mesh``'s refusals;
- the sharded collector: for dp 1, 2, 4 and buckets (2, 4, 8), the same
  groups (rows, segments, zero padding, bytes) over first sight, the fast
  path, the assembly window and stream churn, and the un-sharding when no
  bucket divides;
- the engine: a dp=1 mesh folds bit-identically to one device; at dp 2
  and 4 each tick's results equal JAX's mesh engine on the colour-keyed
  blob gauge (exact boxes), the thumbnails carry the previous tick on each
  slot, ROI routes nothing wrong and matches the single device, the
  cascade's clip state lives per slot and its head scores match the single
  device, per-slot perf and capacity attribution equal JAX's with drift
  0.0, every lease comes back after a dispatch failure, the sharded pool
  bytes are exact;
- ``aot_cache.mesh_spec`` and the mesh-keyed record and replay equal JAX's;
- the tool's gray scene: its wrong classes are edges of each stream's own
  blob; the engine's build launches are counted apart from its batches'.
"""

import importlib.util
import os
import queue
import time

import jax
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.bus.interface import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import aot_cache as jaot
from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.parallel import factor_mesh as jfactor_mesh
from video_edge_ai_proxy_tpu.parallel import make_mesh as jmake_mesh
from video_edge_ai_proxy_tpu.uplink.queue import AnnotationQueue as JAnnotationQueue
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import aot_cache
from video_edge_ai_proxy_tpu_torch.engine.collector import Collector, stream_shard
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, _ShardedThumbPool
from video_edge_ai_proxy_tpu_torch.models.blob import blob_color
from video_edge_ai_proxy_tpu_torch.obs import metrics
from video_edge_ai_proxy_tpu_torch.parallel import (
    assemble_sharded, batch_sharding, factor_mesh, factor_sizes, make_mesh, replicated,
    shard_put,
)
from video_edge_ai_proxy_tpu_torch.temporal.state_pool import ShardedTrackStatePool
from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside five other test workers
    the default (every core) oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the mesh and the placement -------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_factor_mesh_shapes_equal_jax(n):
    mine = factor_mesh(n, prefer=("dp",), devices=["cpu"] * 8)
    theirs = jfactor_mesh(n, prefer=("dp",))
    assert mine.shape == dict(theirs.shape)
    assert mine.size == n and mine.devices == [torch.device("cpu")] * n
    # The default preference's factoring (sp/tp past dp) is JAX's too; the
    # port builds only the dp part.
    assert factor_sizes(n) == dict(jfactor_mesh(n).shape)


@pytest.mark.parametrize("kw,devices,error", [
    ({"dp": 2}, ["cpu"], ValueError),
    ({"dp": 1}, ["cpu", "cpu"], ValueError),
    ({"dp": 2, "tp": 2}, ["cpu"] * 4, NotImplementedError),
    ({"dp": 1, "sp": 2}, ["cpu"] * 2, NotImplementedError),
    ({"dp": 0}, [], ValueError),
], ids=["too_few", "too_many", "tp", "sp", "zero"])
def test_make_mesh_refusals(kw, devices, error):
    with pytest.raises(error):
        make_mesh(**kw, devices=devices)
    if error is ValueError and kw.get("dp", 1) >= 1:
        # JAX's make_mesh refuses the same count mismatch.
        with pytest.raises(ValueError):
            jmake_mesh(**kw, devices=jax.devices()[:len(devices)])


def test_factor_mesh_refuses_model_axes_naming_the_later_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        factor_mesh(4, devices=["cpu"] * 4)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_put_and_assemble_round_trip(dp):
    mesh = make_mesh(dp=dp, devices=["cpu"] * dp)
    frames = np.random.default_rng(dp).integers(0, 256, (8, 6, 5, 3), np.uint8)
    sharding = batch_sharding(mesh, frames.ndim)
    pieces = shard_put(frames, sharding)
    assert [tuple(p.shape) for p in pieces] == [(8 // dp, 6, 5, 3)] * dp
    for s, p in enumerate(pieces):
        np.testing.assert_array_equal(p.numpy(), frames[s * 8 // dp:(s + 1) * 8 // dp])
    np.testing.assert_array_equal(assemble_sharded(pieces, frames.shape, sharding), frames)
    assert replicated(mesh).devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        sharding.segments(7 if dp > 1 else 7.5)


# -- the sharded collector ------------------------------------------------------------


def _frame(value: int, h=48, w=64):
    f = np.full((h, w, 3), value % 256, np.uint8)
    f[0, :, 0] = np.arange(w) % 256
    return f


def _collect_both(col, jcol, window: bool):
    """One tick of each collector (with the assembly window first when
    ``window``) -> the groups of each, compared field for field."""
    if window:
        col.plan_assembly()
        jcol.plan_assembly()
        assert col.assemble_step() == jcol.assemble_step()
    mine, theirs = col.collect(), jcol.collect()
    assert len(mine) == len(theirs)
    for g, jg in zip(mine, theirs):
        assert (g.device_ids, g.bucket, g.src_hw, g.model) == \
            (jg.device_ids, jg.bucket, tuple(jg.src_hw), jg.model)
        assert g.rows == (list(jg.rows) if jg.rows is not None else None)
        assert [m.timestamp_ms for m in g.metas] == [m.timestamp_ms for m in jg.metas]
        np.testing.assert_array_equal(g.frames, jg.frames)
        col.release(g)
        jcol.release(jg)
    return mine


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_sharded_collector_equals_jax(dp):
    bus, jbus = MemoryFrameBus(), JMemoryFrameBus()
    try:
        col = Collector(bus, buckets=(2, 4, 8), strict_lease=True, shards=dp)
        jcol = jcollector.Collector(jbus, buckets=(2, 4, 8), strict_lease=True, shards=dp)
        ids = [f"cam{i}" for i in range(11)]
        rng = np.random.default_rng(dp)
        for d in ids:
            bus.create_stream(d, 48 * 64 * 3)
            jbus.create_stream(d, 48 * 64 * 3)
        seen_rows = set()
        for tick in range(8):
            # Streams come and go: a shifting subset publishes each tick.
            live = [d for d in ids if rng.random() < 0.7] or ids[:1]
            for d in live:
                v = int(rng.integers(0, 256))
                bus.publish(d, _frame(v), FrameMeta(width=64, height=48, channels=3,
                                                   timestamp_ms=1000 + tick))
                jbus.publish(d, _frame(v), JFrameMeta(width=64, height=48, channels=3,
                                                      timestamp_ms=1000 + tick))
            groups = _collect_both(col, jcol, window=tick % 2 == 1)
            for g in groups:
                if g.rows is not None:
                    seen_rows.update(g.rows)
                    seg = g.bucket // dp
                    # Each row in its stream's slot's segment; pad rows zero.
                    assert all(r // seg == stream_shard(d, dp)
                               for d, r in zip(g.device_ids, g.rows))
                    pad = [r for r in range(g.bucket) if r not in g.rows]
                    assert not g.frames[pad].any()
        assert (dp > 1) == bool(seen_rows)
    finally:
        bus.close()
        jbus.close()


def test_no_bucket_divides_serves_unsharded_as_jax():
    for mod, bus_cls in ((None, MemoryFrameBus), (jcollector, JMemoryFrameBus)):
        bus = bus_cls()
        try:
            col = (Collector if mod is None else mod.Collector)(bus, buckets=(1, 2), shards=4)
            assert col._shards == 1 and col._buckets == (1, 2)
        finally:
            bus.close()


def test_repin_drops_the_window_and_refilters_buckets():
    bus = MemoryFrameBus()
    try:
        col = Collector(bus, buckets=(2, 4, 8), shards=4)
        bus.create_stream("cam0", 48 * 64 * 3)
        bus.publish("cam0", _frame(1), FrameMeta(width=64, height=48, channels=3))
        col.collect()
        col.plan_assembly()
        assert col._window is not None
        col.repin(shards=3, shard_of=lambda d: 2, buckets=(2, 3, 4, 6, 8))
        assert col._window is None and col._buckets == (3, 6) and col._shards == 3
        bus.publish("cam0", _frame(2), FrameMeta(width=64, height=48, channels=3))
        (g,) = col.collect()
        assert g.bucket == 3 and g.rows == [2]
    finally:
        bus.close()


# -- the engine on a mesh ---------------------------------------------------------------

STREAMS = {1: ["cam0", "cam4"], 2: ["cam0", "cam1", "cam4", "cam5"],
           4: ["cam0", "cam1", "cam2", "cam3", "cam4", "cam5", "cam6", "cam7"]}


def _scene(key: int, x: int, y: int = 20, w: int = 14, h: int = 10):
    frame = np.full((64, 64, 3), 114, np.uint8)
    frame[y:y + h, x:x + w] = blob_color(key)
    return frame


def _drain(e):
    while True:
        try:
            inflight = e._drain_q.get_nowait()
        except queue.Empty:
            return
        try:
            e._emit(inflight)
        finally:
            e._collector.release(inflight.group)
            e._drain_q.task_done()


def _results(q):
    out = []
    while not q.empty():
        r = q.get_nowait()
        out.append((r.device_id, r.timestamp, sorted(
            (d.class_id, d.box.left, d.box.top, d.box.width, d.box.height) for d in r.detections)))
    return sorted(out)


class _MeshPair:
    """A hand-stepped tiny_blob_gauge engine of each package on a dp mesh
    (JAX's virtual devices, the port's ``cpu`` slots), fed the same
    frames; ``tick`` returns each's results."""

    def __init__(self, dp: int, jax_side: bool = True, **cfg_kw):
        base = dict(model="tiny_blob_gauge", batch_buckets=(2, 4, 8), tick_ms=5,
                    prefetch=False, mesh={"dp": dp}, **cfg_kw)
        if cfg_kw.get("roi"):
            base.update(roi_canvas=64, roi_min_crop=8, roi_full_interval_ms=600_000)
        self.dp = dp
        self.streams = STREAMS[dp]
        self.engines = [InferenceEngine(MemoryFrameBus(), EngineConfig(**base), device="cpu",
                                        slots=["cpu"] * dp,
                                        annotations=AnnotationQueue(handler=lambda b: True))]
        if jax_side:
            self.engines.append(jrunner.InferenceEngine(
                JMemoryFrameBus(), JEngineConfig(**base),
                annotations=JAnnotationQueue(handler=lambda b: True)))
        self.subs = []
        for e in self.engines:
            e.warmup()
            e._drain_q = queue.Queue(maxsize=8)
            q = queue.Queue()
            with e._sub_lock:
                e._subscribers.append((q, None))
            self.subs.append(q)
            for sid in self.streams:
                e._bus.create_stream(sid, 64 * 64 * 3)
        self.ts = 1_700_000_000_000

    @property
    def eng(self):
        return self.engines[0]

    def close(self):
        for e in self.engines:
            e._bus.close()

    def tick(self, frames: dict, steer: float = None):
        self.ts += 33
        for e in self.engines:
            meta = FrameMeta if e is self.eng else JFrameMeta
            for sid, frame in frames.items():
                e._bus.publish(sid, frame, meta(width=64, height=64, channels=3,
                                                timestamp_ms=self.ts, is_keyframe=True))
                if steer is not None and e._roi is not None:
                    e._roi.state(sid)["diff"] = steer
        out = []
        for e, q in zip(self.engines, self.subs):
            groups = e._collector.collect()
            if e._roi is not None:
                groups = e._roi_transform(groups)
            e._dispatch(groups, time.time())
            _drain(e)
            if e._cascade is not None:
                e._cascade_tick()
            out.append(_results(q))
        if len(out) == 2:
            assert out[0] == out[1]
        return out[0]


def _movers(streams, step):
    """Stream i's blob of colour key i, moving along x."""
    return {sid: _scene(i, x=4 + (3 * step + 5 * i) % 40, y=8 + 4 * i)
            for i, sid in enumerate(streams)}


def test_dp1_mesh_folds_bit_identical_to_one_device():
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior

    rng = np.random.default_rng(0)
    streams = ["cam0", "cam1", "cam2"]
    ticks = [[(s, rng.integers(0, 256, (48, 64, 3), np.uint8),
               FrameMeta(width=64, height=48, channels=3, timestamp_ms=1000 + 33 * t,
                         packet=t + 1)) for s in streams] for t in range(3)]
    spec = registry.get("tiny_yolov8")
    folds = []
    for mesh, slots in (({}, None), ({"dp": 1}, ["cpu"])):
        net = spec.init_params(torch.Generator().manual_seed(0), device="cpu",
                               dtype=torch.float32)
        net.load_state_dict(zero_class_prior(dict(net.state_dict())))
        bus = MemoryFrameBus()
        try:
            eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", mesh=mesh,
                                                    batch_buckets=(2, 4), prefetch=False,
                                                    dtype="float32"),
                                  device="cpu", slots=slots, model=net)
            folds.append(eng.serve_lockstep(ticks))
            if mesh:
                assert eng._mesh.shape["dp"] == 1 and eng.pipeline_stats().slot_batches == 3
        finally:
            bus.close()
    assert folds[0] == folds[1] != 0


def test_dp1_mesh_lockstep_checksum_bit_identical(tmp_path):
    from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
    from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace

    path = record_synthetic_trace(str(tmp_path / "t.vtrace"), ["det0", "det1"], width=128,
                                  height=96, fps=30.0, gop=30, frames=6)
    plain = lockstep_checksum(path, model="tiny_yolov8", device="cpu")
    mesh = lockstep_checksum(path, model="tiny_yolov8", device="cpu",
                             mesh=make_mesh(devices=["cpu"]))
    assert plain["checksum"] == mesh["checksum"] != 0
    assert plain["batches"] == mesh["batches"]


@pytest.mark.parametrize("dp", [2, 4])
def test_mesh_results_equal_jax_and_thumbs_carry_per_slot(dp):
    pair = _MeshPair(dp)
    try:
        assert isinstance(pair.eng._thumbs, _ShardedThumbPool)
        for step in range(4):
            res = pair.tick(_movers(pair.streams, step))
            assert [r[0] for r in res] == sorted(pair.streams)
            assert all(len(r[2]) == 1 for r in res)
            # Each stream's thumbnail lives on its slot, equal to JAX's.
            mine, theirs = pair.eng._thumbs.subs, pair.engines[1]._thumbs._subs
            for s in range(dp):
                assert sorted(mine[s]._slots) == sorted(theirs[s]._slots)
                assert all(stream_shard(d, dp) == s for d in mine[s]._slots)
                for d, row in mine[s]._slots.items():
                    np.testing.assert_allclose(
                        mine[s]._pool[row].numpy(),
                        np.asarray(theirs[s]._pool)[theirs[s]._slots[d]], rtol=2e-4,
                        atol=2e-4)
        assert pair.eng.pipeline_stats().slot_batches == 4 * dp
    finally:
        pair.close()


def test_mesh_roi_routes_nothing_wrong_and_matches_jax_and_one_device():
    pair = _MeshPair(2, roi=True)
    single = _MeshPair.__new__(_MeshPair)
    bus = MemoryFrameBus()
    single_eng = InferenceEngine(bus, EngineConfig(
        model="tiny_blob_gauge", batch_buckets=(2, 4, 8), tick_ms=5, prefetch=False, roi=True,
        roi_canvas=64, roi_min_crop=8, roi_full_interval_ms=600_000), device="cpu",
        annotations=AnnotationQueue(handler=lambda b: True))
    single.engines, single.streams, single.ts = [single_eng], pair.streams, pair.ts
    single_eng.warmup()
    single_eng._drain_q = queue.Queue(maxsize=8)
    q = queue.Queue()
    with single_eng._sub_lock:
        single_eng._subscribers.append((q, None))
    single.subs = [q]
    for sid in pair.streams:
        bus.create_stream(sid, 64 * 64 * 3)
    try:
        for step in range(5):
            frames = _movers(pair.streams, step)
            steer = None if step == 0 else 1.0    # a full refresh, then motion
            got = pair.tick(frames, steer)
            assert got == single.tick(frames, steer)
            assert all(r[2] and r[2][0][0] == pair.streams.index(r[0]) for r in got)
        snap = pair.eng.perf.snapshot()["roi"]
        assert snap["unrouted"] == 0 and snap["crops"] > 0 and snap["canvases"] > 0
    finally:
        pair.close()
        bus.close()


def test_mesh_cascade_keeps_clip_state_per_slot_and_matches_one_device():
    cfg = dict(model="tiny_blob_gauge", batch_buckets=(2, 4), tick_ms=5, prefetch=False,
               cascade=True, cascade_model="tiny_videomae", cascade_every_n=2, hbm=True)
    streams = ["cam0", "cam4"]
    scores = []
    for mesh, slots in (({"dp": 2}, ["cpu", "cpu"]), ({}, None)):
        bus = MemoryFrameBus()
        try:
            eng = InferenceEngine(bus, EngineConfig(mesh=mesh, **cfg), device="cpu",
                                  slots=slots, annotations=AnnotationQueue(handler=lambda b: 1))
            eng.warmup()
            eng._drain_q = queue.Queue(maxsize=8)
            for sid in streams:
                bus.create_stream(sid, 64 * 64 * 3)
            for f in range(10):
                for i, sid in enumerate(streams):
                    bus.publish(sid, _scene(i + 1, x=20, y=20 + (3 if f % 2 else -3)),
                                FrameMeta(width=64, height=64, channels=3,
                                          timestamp_ms=1000 + 33 * f))
                eng._dispatch(eng._collector.collect(), time.time())
                _drain(eng)
                eng._cascade_tick()
            snap = eng.cascade.snapshot()
            assert snap["head_dispatches"] > 0
            scores.append({k: v["last_score"] for k, v in snap["tracks"].items()})
            pool = eng._cascade._pool
            if mesh:
                assert isinstance(pool, ShardedTrackStatePool)
                assert all(len(p) > 0 for p in pool.pools)
                assert all(stream_shard(k.split("#")[0], 2) == s
                           for s, p in enumerate(pool.pools) for k in p)
                tracked = eng.hbm.pools()["pools"]["track_state"]
                assert tracked["shards"] == pool.nbytes()
                assert tracked["bytes"] == sum(pool.nbytes().values()) > 0
                thumbs = eng.hbm.pools()["pools"]["thumbs"]
                assert thumbs["shards"] == {str(s): sub.nbytes()
                                            for s, sub in enumerate(eng._thumbs.subs)}
        finally:
            bus.close()
    assert scores[0].keys() == scores[1].keys() and scores[0]
    for k in scores[0]:
        np.testing.assert_allclose(scores[0][k], scores[1][k], rtol=2e-4, atol=2e-4)


def _shard_lines(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ") and "_shard_" in line.split()[2]}


def test_per_slot_perf_and_capacity_equal_jax():
    pair = _MeshPair(2, capacity=True)
    try:
        for step in range(3):
            pair.tick(_movers(pair.streams, step))
        snaps = [e.perf.snapshot() for e in pair.engines]
        frames = [{(r["model"], r["bucket"], r["shard"]): r["frames"] for r in s["shards"]}
                  for s in snaps]
        assert frames[0] == frames[1] and len(frames[0]) == 2
        cons = [e.capacity.conservation() for e in pair.engines]
        for c in cons:
            assert c["rel_drift"] == 0.0 and set(c["shards"]) == {"0", "1"}
            assert all(r["rel_drift"] == 0.0 for r in c["shards"].values())
        mine, theirs = metrics.registry.render(), jmetrics.registry.render()
        assert _shard_lines(mine) == _shard_lines(theirs) != set()
        assert [p for p in metrics.lint_exposition(mine) if "_shard_" in p] == []
    finally:
        pair.close()


def test_mesh_dispatch_failure_returns_every_lease():
    """JAX's test: two geometries on a dp=2 mesh, the step raises for both:
    every pooled lease comes back."""
    bus = MemoryFrameBus()
    try:
        for did, hw in (("cam0", (64, 64)), ("cam4", (64, 64)), ("cam1", (48, 64)),
                        ("cam5", (48, 64))):
            bus.create_stream(did, hw[0] * hw[1] * 3)
            bus.publish(did, np.full(hw + (3,), 128, np.uint8),
                        FrameMeta(width=hw[1], height=hw[0], channels=3))
        eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2, 4),
                                                mesh={"dp": 2}, fault=True), device="cpu",
                              slots=["cpu", "cpu"],
                              annotations=AnnotationQueue(handler=lambda b: True))
        eng.warmup()
        groups = eng._collector.collect()
        assert len(groups) == 2 and all(g.rows is not None for g in groups)

        def boom(src_hw, bucket, model=None):
            raise RuntimeError("compile exploded")

        eng._step = boom
        eng._xfer.start()
        try:
            eng._dispatch(groups, time.perf_counter())
        finally:
            eng._xfer.stop()
        assert all(g.lease is None for g in groups)
        with eng._collector._pool_lock:
            assert all(not slot["leased"] for slot in eng._collector._pool.values())
        bal = eng.faults.ledger.balance()
        assert bal["dropped"] == {"dispatch_error": 4} and bal["lost"] == 0
    finally:
        bus.close()


def test_mesh_auto_takes_every_slot():
    for slots, dp in ((None, 1), (["cpu"] * 4, 4)):
        bus = MemoryFrameBus()
        try:
            eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge", mesh="auto",
                                                    batch_buckets=(1, 2, 4, 8)),
                                  device="cpu", slots=slots)
            eng.warmup()
            assert eng._mesh.shape["dp"] == dp and eng._buckets == tuple(
                b for b in (1, 2, 4, 8) if b % dp == 0)
        finally:
            bus.close()


def _multichip_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_multichip_serve_smoke",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "torch_multichip_serve_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hand_stepped_blob_leg(tool, background: str, steps: int = 32) -> dict:
    """The tool's dp=1 fleet (cam0, cam4) on its ``background``, 270x480
    into the gauge's 64, hand-stepped through a dp=1 mesh engine with ROI
    (a full refresh, then motion every tick): each wrong class with
    whether it lies on its stream's own blob (``tool.on_own_blob``)."""
    h, w = 270, 480
    owners = {"cam0": 0, "cam4": 4}
    scene = tool.BlobScene(h, w, owners.values(), background)
    margin = max(4, 4 * -(-max(h, w) // 64))
    bus = MemoryFrameBus()
    try:
        e = InferenceEngine(bus, EngineConfig(
            model="tiny_blob_gauge", batch_buckets=(2, 4, 8), tick_ms=5, prefetch=False,
            mesh={"dp": 1}, roi=True, roi_canvas=64, roi_min_crop=8,
            roi_full_interval_ms=600_000), device="cpu", slots=["cpu"],
            annotations=AnnotationQueue(handler=lambda b: True))
        e.warmup()
        e._drain_q = queue.Queue(maxsize=8)
        q = queue.Queue()
        with e._sub_lock:
            e._subscribers.append((q, None))
        for sid in owners:
            bus.create_stream(sid, h * w * 3)
        rects, matched, wrong = {}, 0, []
        for step in range(steps):
            ts = 1_700_000_000_000 + 33 * step
            for sid, owner in owners.items():
                bus.publish(sid, scene.frame(owner, step), FrameMeta(
                    width=w, height=h, channels=3, timestamp_ms=ts, is_keyframe=True))
                rects[(sid, ts)] = scene.rect(owner)
                if step:
                    e._roi.state(sid)["diff"] = 1.0
            e._dispatch(e._roi_transform(e._collector.collect()), time.time())
            _drain(e)
            while not q.empty():
                r = q.get_nowait()
                owner = owners[r.device_id]
                for d in r.detections:
                    if d.class_id == owner:
                        matched += 1
                        continue
                    box = (d.box.left, d.box.top, d.box.width, d.box.height)
                    wrong.append((owner, d.class_id, tool.on_own_blob(
                        box, rects[(r.device_id, r.timestamp)], margin,
                        coasted=r.batch_size == 0)))
        return {"matched": matched, "wrong": wrong,
                "unrouted": e.perf.snapshot()["roi"]["unrouted"]}
    finally:
        bus.close()


def test_gray_scene_wrong_classes_are_edges_of_the_streams_own_blob():
    """The JAX tool's gray scene, resized by the letterbox: a blob edge
    blended into the gray reads as a key between the owner's and gray's,
    a wrong class on the stream's own blob, not a crop routed from another
    stream. At dp=1 the streams are owners 0 and 4 (keys 16 and 144 of
    red, gray 114 in bin 3), so a routing fault could only swap 0 and 4;
    every wrong class lies strictly between the owner's bin and gray's,
    inside the owner's blob (a coasted result: on its row). The key-red
    scene that the tool serves by default shows none."""
    tool = _multichip_tool()
    gray = _hand_stepped_blob_leg(tool, "gray")
    assert gray["wrong"] and gray["matched"] >= 20 and gray["unrouted"] == 0
    for owner, cls, own in gray["wrong"]:
        assert min(owner, 3) < cls < max(owner, 3) and own, (owner, cls, own)
    key = _hand_stepped_blob_leg(tool, "key")
    assert key["wrong"] == [] and key["matched"] >= 20 and key["unrouted"] == 0


def test_build_launches_are_counted_apart_from_batches_once_when_nested():
    """``PipelineStats.build_launches``: the kernel launches made inside
    ``_building`` (a capture's warm-up calls, compile_for, start()'s warm-up
    batches), by wrapper name, counted once when builds nest (compile_for
    capturing its graph); launches outside it are the batches'."""
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    bus = MemoryFrameBus()
    before = nms_keep_mask_cuda.launches
    try:
        eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge"), device="cpu")
        with eng._building():
            nms_keep_mask_cuda.launches += 3
            with eng._building():
                nms_keep_mask_cuda.launches += 1
        nms_keep_mask_cuda.launches += 5       # a batch's
        with eng._building():
            pass
        stats = eng.pipeline_stats()
        assert stats.build_launches == {"nms_keep_mask_cuda": 4}
        stats.build_launches["nms_keep_mask_cuda"] = 0   # a copy
        assert eng.pipeline_stats().build_launches == {"nms_keep_mask_cuda": 4}
    finally:
        nms_keep_mask_cuda.launches = before
        bus.close()


def test_int8_under_a_mesh_raises_naming_the_later_slice():
    bus = MemoryFrameBus()
    try:
        eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", mesh={"dp": 1},
                                                quantize="int8"), device="cpu", slots=["cpu"])
        with pytest.raises(NotImplementedError, match="later slice"):
            eng.warmup()
    finally:
        bus.close()


# -- the mesh-keyed prewarm manifest -----------------------------------------------------


def test_mesh_spec_and_keyed_manifest_equal_jax(tmp_path, monkeypatch):
    for dp in (1, 2, 4):
        mine = make_mesh(dp=dp, devices=["cpu"] * dp)
        theirs = jmake_mesh(dp=dp, devices=jax.devices()[:dp])
        assert aot_cache.mesh_spec(mine) == jaot.mesh_spec(theirs)
    assert aot_cache.mesh_spec(None) == jaot.mesh_spec(None) == []
    assert aot_cache.mesh_spec([["dp", 2], ["tp", 1]]) == jaot.mesh_spec([["dp", 2], ["tp", 1]])
    d = str(tmp_path / "aot")
    for mesh in (None, make_mesh(dp=2, devices=["cpu"] * 2)):
        aot_cache.record_program(d, model="tiny_yolov8", stem="classic", src_hw=(64, 64),
                                 bucket=4, mesh=mesh)
    aot_cache.record_program(d, model=None, stem="classic", src_hw=(48, 64), bucket=2,
                             mesh=[["dp", 2]])
    programs = aot_cache.load_manifest(d)
    assert len(programs) == 3
    for mesh in (None, [["dp", 2]], [["dp", 4]]):
        assert aot_cache.prewarm_entries(programs, mesh=mesh) == jaot.prewarm_entries(
            programs, mesh=mesh)
    assert aot_cache.prewarm_entries(programs, mesh=[["dp", 2]]) == [
        [64, 64, 4, "tiny_yolov8", "classic"], [48, 64, 2, "", "classic"]]
    assert aot_cache.prewarm_entries(programs) == [[64, 64, 4, "tiny_yolov8", "classic"]]

"""The port's serving-pipeline host modules against the JAX package's.

The same inputs, made from seeded numpy generators, go through both
packages' functions; unless a test says otherwise the results must be
equal exactly (host code, the same float32 and Python-float arithmetic):

- ``IoUTracker`` ids and track state over seeded box sequences, and the
  engine's ``_assign_tracks`` across a model switch;
- ``DegradationLadder`` rungs over scripted queue depths and tick lags on
  an injected clock;
- ``SLOEngine.evaluate`` burn rates, firing and episodes over scripted
  good and bad samples on an injected clock;
- ``QualityTracker`` verdicts and snapshots over scripted luma, variance,
  diff and detections on an injected clock;
- ``shed_stale`` and ``admitted_streams`` on the same groups;
- the collector's lease rules (the JAX package's collector tests, run on
  the port's collector) and its doorbell-woken assembly window;
- the collector's ``restrict``;
- the engine on the CPU: results with track ids, quality verdicts, the
  ladder at ``normal``, the state of a stream gone from the bus dropped
  after the grace period, and a transfer-thread error raised by
  ``stop()``; a failed graph capture ends the allocator's recording into
  its pool (``_end_pool_recording``, torch's call stubbed).
"""

import logging
import threading
import time
import types

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.engine.collector import BatchGroup as JBatchGroup
from video_edge_ai_proxy_tpu.engine.tracker import IoUTracker as JIoUTracker
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs.quality import QualityTracker as JQualityTracker
from video_edge_ai_proxy_tpu.obs.slo import SLOEngine as JSLOEngine
from video_edge_ai_proxy_tpu.obs.slo import default_slos as jdefault_slos
from video_edge_ai_proxy_tpu.resilience.ladder import DegradationLadder as JLadder
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import runner
from video_edge_ai_proxy_tpu_torch.engine.collector import BatchGroup, Collector
from video_edge_ai_proxy_tpu_torch.engine.runner import BoundingBox, Detection, InferenceEngine
from video_edge_ai_proxy_tpu_torch.engine.tracker import IoUTracker
from video_edge_ai_proxy_tpu_torch.obs import metrics
from video_edge_ai_proxy_tpu_torch.obs.quality import QualityTracker
from video_edge_ai_proxy_tpu_torch.obs.slo import SLOEngine, default_slos
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.resilience.ladder import DegradationLadder
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- tracker --------------------------------------------------------------


def _scene(rng, n_objects=12):
    xy = rng.uniform(0, 400, (n_objects, 2))
    return np.concatenate([xy, xy + rng.uniform(8, 80, (n_objects, 2))], axis=1)


def _frame_boxes(rng, scene, f):
    """A random subset of the scene's objects, drifting, with jitter; a few
    frames empty. Boxes as the engine hands them over: int pixels."""
    if f % 13 == 12:
        return np.zeros((0, 4)), np.zeros(0, np.int64), np.zeros(0)
    n = int(rng.integers(0, len(scene) + 1))
    idx = rng.choice(len(scene), n, replace=False)
    boxes = np.round(scene[idx] + 2.0 * f + rng.normal(0, 3, (n, 4)))
    return boxes, (idx % 3).astype(np.int64), rng.uniform(0.25, 1.0, n)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_misses", [2, 30])
def test_tracker_ids_and_state_equal_jax(seed, max_misses):
    rng = np.random.default_rng(seed)
    scene = _scene(rng)
    want, got = JIoUTracker(max_misses=max_misses), IoUTracker(max_misses=max_misses)
    now = 0.0
    for f in range(60):
        # A gap longer than max_gap_s clears the tracks in both.
        now += 11.0 if f == 40 else 1 / 30
        boxes, classes, scores = _frame_boxes(rng, scene, f)
        s = None if f % 5 == 4 else scores.tolist()
        a = want.update(boxes.tolist(), classes.tolist(), now=now, scores=s)
        b = got.update(boxes.tolist(), classes.tolist(), now=now, scores=s)
        assert a == b, f
        assert want.tracks() == got.tracks(), f
        assert (want.next_id, want.live_tracks) == (got.next_id, got.live_tracks)


def _dets(boxes, classes, scores):
    return [Detection(box=BoundingBox(left=int(b[0]), top=int(b[1]), width=int(b[2] - b[0]),
                                      height=int(b[3] - b[1])),
                      confidence=float(s), class_id=int(c))
            for b, c, s in zip(boxes, classes, scores)]


def test_assign_tracks_across_a_model_switch_equals_jax():
    """The engines' per-stream association: a model switch resets the
    stream's tracker, and the new one continues the old one's numbering."""
    rng = np.random.default_rng(7)
    scene = _scene(rng)
    jself = types.SimpleNamespace(_trackers={}, _state_lock=threading.Lock())
    pself = types.SimpleNamespace(_trackers={}, _state_lock=threading.Lock())
    for f in range(30):
        model = "yolov8n" if f < 12 or f >= 20 else "yolov8s"
        for stream in ("cam0", "cam1"):
            boxes, classes, scores = _frame_boxes(rng, scene, f)
            jd, pd = _dets(boxes, classes, scores), _dets(boxes, classes, scores)
            jrunner.InferenceEngine._assign_tracks(jself, stream, model, jd)
            InferenceEngine._assign_tracks(pself, stream, model, pd)
            assert [d.track_id for d in jd] == [d.track_id for d in pd]
            assert all(d.track_id for d in pd)
    for stream in ("cam0", "cam1"):
        assert jself._trackers[stream][1].next_id == pself._trackers[stream][1].next_id > 1


# -- degradation ladder -----------------------------------------------------

# (queue depth, tick lag s) per tick at 10 ms ticks: sustained depth
# pressure, lag pressure, flapping pressure, recovery all the way down.
_LADDER_SCRIPTS = {
    "depth_then_recover": [(2, 0.0)] * 250 + [(0, 0.0)] * 900,
    "lag_then_recover": [(0, 0.05)] * 120 + [(0, 0.001)] * 500,
    "flapping": [(2, 0.0), (0, 0.0)] * 300 + [(3, 0.2)] * 80 + [(0, 0.0)] * 300,
    "slo_burn": [(0, 0.0)] * 650,     # burning on ticks 50..249
}


@pytest.mark.parametrize("script", sorted(_LADDER_SCRIPTS))
def test_ladder_rungs_equal_jax(script):
    jclock, pclock = FakeClock(), FakeClock()
    want = JLadder(clock=jclock)
    got = DegradationLadder(clock=pclock)
    seen = set()
    for i, (depth, lag) in enumerate(_LADDER_SCRIPTS[script]):
        jclock.t += 0.01
        pclock.t += 0.01
        burning = script == "slo_burn" and 50 <= i < 250
        a = want.observe(queue_depth=depth, tick_lag_s=lag, tick_budget_s=0.01,
                         slo_burning=burning)
        b = got.observe(queue_depth=depth, tick_lag_s=lag, tick_budget_s=0.01,
                        slo_burning=burning)
        assert a == b, i
        seen.add(b)
    assert want.transitions == got.transitions
    assert len(seen) > 1


# -- SLOs ---------------------------------------------------------------------


@pytest.mark.parametrize("bad_share", [0.0, 0.3, 0.7, 1.0])
def test_slo_burn_rates_and_episodes_equal_jax(bad_share):
    rng = np.random.default_rng(int(bad_share * 10))
    jclock, pclock = FakeClock(0.0), FakeClock(0.0)
    kw = dict(latency_ms=40.0, target_fps=1000.0, warmup_s=30.0)
    want = JSLOEngine(jdefault_slos(**kw), clock=jclock, registry=jmetrics.Registry())
    got = SLOEngine(default_slos(**kw), clock=pclock, registry=metrics.Registry())
    for second in range(800):
        # A bad excursion, then a recovery.
        share = bad_share if 50 <= second < 500 else 0.05
        for name in ("detect_latency_p50", "aggregate_fps", "stream_availability"):
            bad = float((rng.uniform(size=20) < share).sum())
            want.record(name, good=20.0 - bad, bad=bad)
            got.record(name, good=20.0 - bad, bad=bad)
        jclock.t += 1.0
        pclock.t += 1.0
        a, b = want.evaluate(), got.evaluate()
        assert a == b, second
    assert want.snapshot() == got.snapshot()
    slos = got.snapshot()["slos"]
    assert slos["detect_latency_p50"]["episodes"] == (1 if bad_share >= 0.7 else 0)
    assert slos["aggregate_fps"]["episodes"] == (1 if bad_share >= 0.3 else 0)
    assert not got.burning()


# -- quality -------------------------------------------------------------------

_QUALITY_PHASES = (
    # (ticks, luma, var, diff, detections per frame)
    (60, 0.5, 0.02, 1e-3, 3),      # healthy
    (90, 0.01, 1e-5, 1e-3, 0),     # black
    (90, 0.5, 0.02, 1e-9, 2),      # frozen
    (90, 0.5, 0.02, 1e-3, 3),      # recovery
    (400, 0.5, 0.02, 1e-3, 0),     # flatline
    (120, 0.5, 0.02, 1e-3, 6),     # drifted detections
)


@pytest.mark.parametrize("with_stats", [True, False])
def test_quality_verdicts_and_snapshot_equal_jax(with_stats):
    rng = np.random.default_rng(3)
    jclock, pclock = FakeClock(), FakeClock()
    kw = dict(enter_s=1.0, exit_s=1.0, flatline_s=5.0, window_s=2.0)
    want = JQualityTracker(clock=jclock, registry=jmetrics.Registry(), **kw)
    got = QualityTracker(clock=pclock, registry=metrics.Registry(), **kw)
    verdicts = set()
    for ticks, luma, var, diff, n_det in _QUALITY_PHASES:
        for _ in range(ticks):
            jclock.t += 0.05
            pclock.t += 0.05
            for stream in ("cam0", "cam1"):
                n = int(rng.integers(0, 2 * n_det + 1)) if n_det else 0
                classes = rng.integers(0, 4, n).tolist()
                scores = rng.uniform(0.01, 1.0, n).tolist()
                stats = {}
                if with_stats:
                    stats = dict(luma_mean=luma + rng.normal(0, 1e-3),
                                 luma_var=var, diff_energy=diff)
                a = want.observe(stream, classes=classes, scores=scores, **stats)
                b = got.observe(stream, classes=classes, scores=scores, **stats)
                assert a == b
                verdicts.add(b)
            assert want.unhealthy() == got.unhealthy()
    assert want.snapshot() == got.snapshot()
    assert len(verdicts) >= (4 if with_stats else 2)


# -- shedding and admission ----------------------------------------------------------


def _groups(rng, n, bucket):
    frames = rng.integers(0, 256, (bucket, 4, 6, 3), dtype=np.uint8)
    frames[n:] = 0
    ids = [f"cam{i}" for i in range(n)]
    ages = rng.choice([0, 100, 499, 500, 501, 2000], n)
    metas = [FrameMeta(timestamp_ms=0 if a == 0 else int(10_000 - a), packet=i)
             for i, a in enumerate(ages)]
    return ((BatchGroup((4, 6), list(ids), frames.copy(), list(metas), bucket),
             JBatchGroup((4, 6), list(ids), frames.copy(), list(metas), bucket)))


@pytest.mark.parametrize("seed", range(8))
def test_shed_stale_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    bucket = next(b for b in (1, 2, 4, 8) if b >= n)
    group, jgroup = _groups(rng, n, bucket)
    got, shed = runner.shed_stale(group, 10_000.0, 500.0, (1, 2, 4, 8))
    want, jshed = jrunner.shed_stale(jgroup, 10_000.0, 500.0, (1, 2, 4, 8))
    assert shed == jshed
    if want is None:
        assert got is None
        return
    assert (got.device_ids, got.bucket, [m.packet for m in got.metas]) == \
        (want.device_ids, want.bucket, [m.packet for m in want.metas])
    np.testing.assert_array_equal(got.frames, want.frames)


@pytest.mark.parametrize("n,unhealthy", [(0, ()), (1, ("s0",)), (5, ()), (6, ("s1", "s4")),
                                         (9, ("s0", "s1", "s2", "s3", "s4", "s5", "s6"))])
def test_admitted_streams_equal_jax(n, unhealthy):
    ids = [f"s{i}" for i in np.random.default_rng(n).permutation(n)]
    assert runner.admitted_streams(ids, unhealthy) == jrunner.admitted_streams(ids, unhealthy)


# -- collector leases and assembly -------------------------------------------------


def _publish(bus, device_id, value, hw=(64, 64)):
    return bus.publish(device_id, np.full(hw + (3,), value, np.uint8),
                       FrameMeta(width=hw[1], height=hw[0]))


@pytest.fixture
def bus():
    b = MemoryFrameBus()
    yield b
    b.close()


def test_strict_lease_blocks_reuse_until_release(bus):
    col = Collector(bus, buckets=(1,), strict_lease=True)
    bus.create_stream("cam0", 64 * 64 * 3)
    _publish(bus, "cam0", 1)
    col.collect()                            # generic path (first sight)
    held = []
    for v in (10, 20, 30, 40):
        _publish(bus, "cam0", v)
        groups = col.collect()
        assert len(groups) == 1 and groups[0].lease is not None
        held.append(groups[0])
    # four outstanding leases -> four distinct buffers, all intact
    assert len({id(g.frames.base) for g in held}) == 4
    for v, g in zip((10, 20, 30, 40), held):
        assert g.frames[0, 0, 0, 0] == v
    for g in held:
        col.release(g)
        assert g.lease is None
    col.release(held[0])                     # double release: no-op
    # released buffers cycle back instead of growing the pool
    n_bufs = len(col._pool[(1, 64, 64, 3)]["bufs"])
    for v in (50, 60, 70):
        _publish(bus, "cam0", v)
        col.release(col.collect()[0])
    assert len(col._pool[(1, 64, 64, 3)]["bufs"]) == n_bufs


def test_lease_failsafe_caps_pool_growth(bus):
    col = Collector(bus, buckets=(1,), strict_lease=True)
    bus.create_stream("cam0", 64 * 64 * 3)
    _publish(bus, "cam0", 1)
    col.collect()
    for v in range(Collector.MAX_POOL_BUFFERS + 3):   # never released
        _publish(bus, "cam0", v)
        assert col.collect()
    assert len(col._pool[(1, 64, 64, 3)]["bufs"]) <= Collector.MAX_POOL_BUFFERS


def test_failsafe_one_off_buffer_never_steals_live_lease(bus):
    col = Collector(bus, buckets=(1,), strict_lease=True)
    bus.create_stream("cam0", 64 * 64 * 3)
    _publish(bus, "cam0", 1)
    col.collect()
    held = []
    for v in range(Collector.MAX_POOL_BUFFERS):
        _publish(bus, "cam0", 10 + v)
        g = col.collect()[0]
        assert g.lease is not None
        held.append(g)                       # pool now fully leased
    _publish(bus, "cam0", 200)
    extra = col.collect()[0]
    assert extra.lease is None and extra.frames[0, 0, 0, 0] == 200
    for v, g in enumerate(held):             # every live lease keeps its frame
        assert g.frames[0, 0, 0, 0] == 10 + v
    n_bufs = len(col._pool[(1, 64, 64, 3)]["bufs"])
    col.release(extra)                       # no-op by contract
    assert len(col._pool[(1, 64, 64, 3)]["bufs"]) == n_bufs


def test_pad_rows_are_zeroed_only_where_dirty(bus):
    """A pooled buffer that served 4 streams and now serves 2 has its rows
    2..3 zeroed before it is handed out as a bucket of 2."""
    col = Collector(bus, buckets=(2, 4))
    for i in range(4):
        bus.create_stream(f"c{i}", 64 * 64 * 3)
        _publish(bus, f"c{i}", 10 + i)
    col.collect()                            # first sight
    for _ in range(2):                       # the pool's two buffers
        for i in range(4):
            _publish(bus, f"c{i}", 20 + i)
        (g,) = col.collect()
        assert g.bucket == 4 and list(g.frames[:, 0, 0, 0]) == [20, 21, 22, 23]
    _publish(bus, "c1", 30)
    (g,) = col.collect()
    assert g.bucket == 2 and g.device_ids == ["c1"]
    assert g.frames[0, 0, 0, 0] == 30 and not g.frames[1:].any()
    assert not g.frames.base[1:].any()       # rows past the bucket too


def test_assembly_window_reads_frames_as_they_are_published(bus):
    col = Collector(bus, buckets=(1, 2))
    bus.create_stream("cam0", 64 * 64 * 3)
    _publish(bus, "cam0", 1)
    col.collect()                            # geometry now known
    timer = threading.Timer(0.05, lambda: _publish(bus, "cam0", 99))
    timer.start()
    t0 = time.monotonic()
    col.assemble_until(t0 + 0.4)
    timer.join()
    assert col._window is not None and col._window["groups"]
    (g,) = col.collect()
    assert g.frames[0, 0, 0, 0] == 99 and g.device_ids == ["cam0"]


def test_bucket_cap_hides_the_largest_buckets(bus):
    col = Collector(bus, buckets=(1, 2, 4))
    for i in range(3):
        bus.create_stream(f"c{i}", 64 * 64 * 3)
        _publish(bus, f"c{i}", i)
    col.collect()
    col.set_bucket_cap(2)
    for i in range(3):
        _publish(bus, f"c{i}", i + 1)
    assert [g.bucket for g in col.collect()] == [2, 1]
    col.set_bucket_cap(None)
    for i in range(3):
        _publish(bus, f"c{i}", i + 2)
    assert [g.bucket for g in col.collect()] == [4]


def test_restrict_limits_the_streams_read(bus):
    col = Collector(bus, buckets=(1, 2, 4))
    for i in range(3):
        bus.create_stream(f"c{i}", 64 * 64 * 3)
        _publish(bus, f"c{i}", i + 1)
    col.restrict(["c2", "c0"])
    assert col.active_streams() == ["c0", "c2"]
    assert [g.device_ids for g in col.collect()] == [["c0", "c2"]]
    col.restrict(None)
    assert col.active_streams() == ["c0", "c1", "c2"]
    assert [g.device_ids for g in col.collect()] == [["c1"]]   # c0, c2 already read


def test_memory_bus_reads_into_a_slot_and_wakes_on_publish(bus):
    bus.create_stream("cam0", 8 * 8 * 3)
    token = bus.doorbell_token()
    dst = np.zeros((8, 8, 3), np.uint8)
    assert bus.read_latest_into("cam0", dst) is None
    seq = bus.publish("cam0", np.full((8, 8, 3), 7, np.uint8), FrameMeta(packet=3))
    assert bus.doorbell_wait(token, 1.0) != token
    got_seq, meta = bus.read_latest_into("cam0", dst)
    assert (got_seq, meta.packet) == (seq, 3) and (dst == 7).all()
    assert bus.read_latest_into("cam0", dst, min_seq=seq) is None
    other = bus.read_latest_into("cam0", np.zeros((4, 8, 3), np.uint8))
    assert other.seq == seq and other.data.shape == (8, 8, 3)   # the whole frame
    assert bus.head("cam0") == seq
    bus.drop_stream("cam0")
    assert bus.streams() == [] and bus.head("cam0") is None


# -- the engine on the CPU -----------------------------------------------------------------


def _serve(engine, bus, streams, until, publish_every=0.03, timeout=60.0, settle=None):
    results = engine.subscribe()
    got: dict = {}

    def consume():
        for r in results:
            got.setdefault(r.device_id, []).append(r)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    engine.start()
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, (4, 96, 128, 3), dtype=np.uint8)
    try:
        deadline = time.monotonic() + timeout
        packet = 0
        while not until(got):
            assert time.monotonic() < deadline, "streams not served in time"
            packet += 1
            for i, s in enumerate(streams):
                bus.publish(s, pool[(i + packet) % len(pool)],
                            FrameMeta(packet=packet, timestamp_ms=int(time.time() * 1000)))
            time.sleep(publish_every)
        if settle is not None:
            settle()
    finally:
        engine.stop()
    reader.join(5)
    assert not reader.is_alive()
    return got


@pytest.mark.parametrize("prefetch", [True, False])
def test_engine_serves_with_tracks_quality_and_a_calm_ladder(prefetch):
    bus = MemoryFrameBus()
    streams = ["cam0", "cam1", "cam2"]
    for s in streams:
        bus.create_stream(s, 96 * 128 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5,
                                               prefetch=prefetch), device="cpu")
    engine.warmup()
    engine._model.load_state_dict(zero_class_prior(engine._model.state_dict()))
    def calm():
        # A loaded CPU can lag a tick past the ladder's bound; with no new
        # frames it recovers one rung per ladder_recover_after_s.
        deadline = time.monotonic() + 20
        while engine.ladder.rung != "normal" and time.monotonic() < deadline:
            time.sleep(0.05)

    got = _serve(engine, bus, streams, lambda g: all(len(g.get(s, [])) >= 4 for s in streams),
                 settle=calm)
    for s in streams:
        assert all(d.track_id for r in got[s] for d in r.detections)
        assert sum(len(r.detections) for r in got[s]) > 0
        assert all(r.latency_ms >= 0 for r in got[s])
    snap = engine.quality.snapshot()
    assert set(snap["streams"]) == set(streams)
    assert all(v["luma"] is not None for v in snap["streams"].values())
    assert engine.ladder.rung == "normal"
    p = engine.pipeline_stats()
    assert p.frames == sum(len(v) for v in got.values()) and p.batches >= 4
    assert p.emit_ms >= p.track_ms > 0
    assert p.frames + p.shed_frames <= sum(bus.head(s) for s in streams)
    assert engine.checksum > 0
    with engine._collector._pool_lock:        # every lease came back
        assert all(not slot["leased"] for slot in engine._collector._pool.values())
    assert set(engine._thumbs) == set(streams)


@pytest.mark.parametrize("prefetch", [True, False])
def test_the_serving_path_warm_up_is_not_traffic(prefetch):
    """start()'s warm-up of the serving path (the card's; called here on a
    CPU engine): one batch of each built program goes through placement,
    the step and the drain's read-back, and nothing of it is served: no
    result to a subscriber, no stats, pipeline totals, batch metric,
    capacity ledger or checksum, and its lease comes back."""
    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", prefetch=prefetch, capacity=True, batch_buckets=(1, 2),
        prewarm=[[96, 128, 2]]), device="cpu")
    engine.warmup()
    engine._prewarm()
    engine._start_pipeline()
    results = engine.subscribe(timeout=0.05)
    batches = engine._m_device.labels("tiny_yolov8").count
    read = []
    read_back = engine._read_back
    engine._read_back = lambda inflight: read.append(inflight.group.bucket) or read_back(inflight)
    try:
        engine._warm_serving_path()
    finally:
        engine.stop()
    assert read == [2]
    assert list(results) == []
    assert engine.stats() == {} and engine.checksum == 0
    assert engine.pipeline_stats().batches == engine.pipeline_stats().frames == 0
    assert engine._m_device.labels("tiny_yolov8").count == batches
    assert engine.capacity.snapshot()["cells"] == {}
    with engine._collector._pool_lock:
        assert all(not slot["leased"] for slot in engine._collector._pool.values())


def test_absent_stream_state_is_dropped_after_the_grace():
    """A stream gone from the bus keeps its state for the grace period (a
    producer re-creating its ring keeps its track ids), then loses the
    collector's cursor and geometry, its tracker, thumbnail row and
    quality state; the streams still present keep theirs."""
    bus = MemoryFrameBus()
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", prefetch=False),
                             device="cpu")
    engine.warmup()
    engine._model.load_state_dict(zero_class_prior(engine._model.state_dict()))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 2, 96, 128, 3), dtype=np.uint8)
    engine.serve_lockstep([(f"cam{s}", frames[t, s], FrameMeta(packet=t)) for s in range(2)]
                          for t in range(2))
    streams = {"cam0", "cam1"}

    def state():
        return [set(engine._collector._cursors), set(engine._collector._geom),
                set(engine._trackers), set(engine._thumbs),
                set(engine.quality.snapshot()["streams"])]

    assert state() == [streams] * 5
    engine._forget_absent(bus.streams())           # a tick with both present
    bus.drop_stream("cam0")
    engine._forget_absent(bus.streams())
    assert state() == [streams] * 5                # within the grace
    engine._STATE_GC_GRACE_S = 0.0
    time.sleep(0.01)
    engine._forget_absent(bus.streams())
    assert state() == [{"cam1"}] * 5


def test_transfer_error_ends_the_engine_and_stop_raises(caplog):
    """The JAX engine's contract (log and continue): batches whose transfer
    fails are dropped with "engine tick failed; continuing", the engine
    serves once the transfer works again, and stop() does not raise."""
    bus = MemoryFrameBus()
    bus.create_stream("cam0", 96 * 128 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5), device="cpu")
    place = engine._xfer.place
    failures = {"n": 0}

    def broken(frames):
        if failures["n"] < 3:
            failures["n"] += 1
            raise OSError("transfer failed")
        return place(frames)

    engine._xfer.place = broken
    results = engine.subscribe(timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    caplog.set_level(logging.ERROR, logger=runner.log.name)
    engine.start()
    try:
        deadline = time.monotonic() + 30
        while not got:
            assert time.monotonic() < deadline, "the engine did not serve after the failures"
            bus.publish("cam0", np.zeros((96, 128, 3), np.uint8), FrameMeta(packet=1))
            time.sleep(0.02)
        health = engine.health()
    finally:
        engine.stop()
    reader.join(10)
    assert failures["n"] == 3
    assert health["ok"], health
    logged = [r for r in caplog.records if r.getMessage() == "engine tick failed; continuing"]
    assert len(logged) == 3 and all(isinstance(r.exc_info[1], OSError) for r in logged)


def test_a_failed_capture_ends_the_allocators_recording_into_its_pool(monkeypatch):
    """``_end_pool_recording`` ends the recording into the failed capture's
    pool on the capture's device, and a recording the capture had already
    ended (the allocator raises) is no error."""
    import torch

    from video_edge_ai_proxy_tpu_torch.engine import runner

    calls = []

    def end(index, pool):
        calls.append((index, pool))
        if len(calls) > 1:
            raise RuntimeError("endAllocatePool: not currently recording to mempool_id")

    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool", end, raising=False)
    runner._end_pool_recording(torch.device("cuda", 1), (0, 7))
    runner._end_pool_recording(torch.device("cuda", 1), (0, 7))
    assert calls == [(1, (0, 7)), (1, (0, 7))]

"""ROI serving of the port (``engine/runner.py`` ``_RoiGate`` and
``_roi_transform``, ``engine/collector.py`` ``CanvasPacker``,
``ops/boxes.py`` ``uncrop_boxes``, the ``obs/perf.py`` ROI notes, the
blob gauge ``models/blob.py``) against the JAX package's, test for test
with ``tests/test_roi.py`` but its mesh tests.

Every case runs the same inputs, made from a numpy seed or painted from
the gauge's color keys, through both packages:

- the packer's canvases and placements byte for byte, ``uncrop_boxes``
  equal, the gauge's serving outputs equal (its weights carried by
  ``from_flax``), the gate's verdict tables equal, the perf notes' metric
  lines and snapshots equal;
- a hand-stepped ``tiny_blob_gauge`` engine of each package (the JAX
  test's ``_tick`` convention: collect, ``_roi_transform``, dispatch,
  drain) over a scripted full -> roi -> idle sequence: the same results,
  box for box, track id for track id.

The gauge is detect-exact, so the round trips are asserted with array
equality, not an IoU tolerance. The card-only cases are in
``tests/test_torch_cuda_roi_cascade.py``.
"""

import queue
import time

import jax
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.bus.interface import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs.perf import PerfTracker as JPerfTracker
from video_edge_ai_proxy_tpu.ops import boxes as jboxes
from video_edge_ai_proxy_tpu.replay import checksum as jchecksum
from video_edge_ai_proxy_tpu.uplink.queue import AnnotationQueue as JAnnotationQueue
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.collector import CanvasPacker, CropPlacement
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, _RoiGate, build_serving_step
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.blob import blob_color
from video_edge_ai_proxy_tpu_torch.models.carry import load_flax
from video_edge_ai_proxy_tpu_torch.obs import metrics
from video_edge_ai_proxy_tpu_torch.obs.perf import PerfTracker
from video_edge_ai_proxy_tpu_torch.ops.boxes import uncrop_boxes
from video_edge_ai_proxy_tpu_torch.replay import checksum
from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


def _meta(w=64, h=64, ts=None, cls=FrameMeta):
    return cls(width=w, height=h, channels=3, timestamp_ms=ts or int(time.time() * 1000),
               is_keyframe=True)


def _scene(h=64, w=64, blobs=()):
    """Background-gray frame with color-keyed blobs (x0, y0, x1, y1, key):
    the gauge's anchor ``key`` reports exactly (x0, y0, x1, y1)."""
    frame = np.full((h, w, 3), 114, np.uint8)
    for x0, y0, x1, y1, key in blobs:
        frame[y0:y1, x0:x1] = blob_color(key)
    return frame


@pytest.fixture(scope="module")
def gauge_steps():
    """The tiny gauge's serving step of each package on the same weights:
    JAX's jitted, the port's eager on the CPU."""
    spec = jregistry.get("tiny_blob_gauge")
    net, variables = spec.init_params(jax.random.PRNGKey(0))
    jstep = jax.jit(jrunner.build_serving_step(net, spec))
    model = registry.get("tiny_blob_gauge").init_params(device="cpu")
    load_flax(model, jax.tree_util.tree_map(np.asarray, variables))
    step = build_serving_step(model, registry.get("tiny_blob_gauge"))

    def run_jax(frames_u8):
        out = jstep(variables, np.asarray(frames_u8, np.uint8))
        return {k: np.asarray(v) for k, v in out.items()}

    def run(frames_u8):
        out = step(torch.from_numpy(np.ascontiguousarray(frames_u8)))
        host = {k: v.numpy() for k, v in out.items()}
        want = run_jax(frames_u8)
        assert set(host) == set(want)
        for k in want:
            np.testing.assert_array_equal(host[k], want[k], err_msg=k)
        return host

    return run


def _detections(host, i, floor=0.5):
    """(class_id, [x0, y0, x1, y1]) per valid above-floor slot."""
    out = []
    for j in np.nonzero(host["valid"][i])[0]:
        if float(host["scores"][i, j]) < floor:
            continue
        out.append((int(host["classes"][i, j]), [float(v) for v in host["boxes"][i, j]]))
    return out


def _placement_tuple(p):
    return (p.device_id, p.canvas, tuple(p.src), tuple(p.dst), p.scale)


def _pack_both(packer_kw, reqs):
    """Pack ``reqs`` (device_id, frame, roi) with both packers; the
    canvases byte for byte and the placements field for field must agree.
    Returns the port's (canvases, placements, overflow)."""
    mine = CanvasPacker(**packer_kw).pack(
        [(d, _meta(f.shape[1], f.shape[0]), f, roi) for d, f, roi in reqs])
    theirs = jcollector.CanvasPacker(**packer_kw).pack(
        [(d, _meta(f.shape[1], f.shape[0], cls=JFrameMeta), f, roi) for d, f, roi in reqs])
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[0].dtype == theirs[0].dtype == np.uint8
    assert [_placement_tuple(p) for p in mine[1]] == [_placement_tuple(p) for p in theirs[1]]
    assert mine[2] == theirs[2]
    return mine


class TestUncropBoxes:
    def test_identity(self):
        boxes = np.array([[3.0, 4.0, 10.0, 12.0]], np.float32)
        out = uncrop_boxes(boxes, scale=1, dst_origin=(0, 0), src_origin=(0, 0))
        np.testing.assert_array_equal(out, boxes)
        np.testing.assert_array_equal(
            out, jboxes.uncrop_boxes(boxes, scale=1, dst_origin=(0, 0), src_origin=(0, 0)))

    def test_scale_and_origins(self):
        boxes = np.array([2.0, 3.0, 10.0, 7.0], np.float32)
        out = uncrop_boxes(boxes, scale=2, dst_origin=(1, 1), src_origin=(100, 50))
        np.testing.assert_array_equal(out, [102.0, 54.0, 118.0, 62.0])
        np.testing.assert_array_equal(
            out, jboxes.uncrop_boxes(boxes, scale=2, dst_origin=(1, 1), src_origin=(100, 50)))

    @pytest.mark.parametrize("scale", [1, 2, 4])
    def test_exact_inverse_of_forward_placement(self, scale):
        src_box = np.array([32.0, 48.0, 56.0, 64.0], np.float32)
        canvas_box = ((src_box - np.array([24, 40, 24, 40], np.float32)) / scale
                      + np.array([5, 9, 5, 9], np.float32))
        out = uncrop_boxes(canvas_box, scale=scale, dst_origin=(5, 9), src_origin=(24, 40))
        np.testing.assert_array_equal(out, src_box)
        np.testing.assert_array_equal(out, jboxes.uncrop_boxes(
            canvas_box, scale=scale, dst_origin=(5, 9), src_origin=(24, 40)))

    def test_batched_shape_preserved(self):
        boxes = np.random.default_rng(0).uniform(0, 64, (3, 7, 4)).astype(np.float32)
        out = uncrop_boxes(boxes, scale=2, dst_origin=(1, 2), src_origin=(3, 4))
        assert out.shape == (3, 7, 4) and out.dtype == np.float32
        np.testing.assert_array_equal(
            out, jboxes.uncrop_boxes(boxes, scale=2, dst_origin=(1, 2), src_origin=(3, 4)))


class TestCanvasPacker:
    def test_deterministic_byte_identical(self):
        rng = np.random.default_rng(11)
        reqs = [(d, rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), roi)
                for d, roi in (("camB", (0, 0, 30, 24)), ("camA", (10, 10, 28, 25)),
                               ("camC", (4, 4, 24, 28)))]
        kw = dict(side=64, gap=8, max_canvases=4, min_crop=8)
        c1, p1, o1 = _pack_both(kw, reqs)
        c2, p2, o2 = CanvasPacker(**kw).pack([(d, _meta(), f, r) for d, f, r in reqs])
        np.testing.assert_array_equal(c1, c2)
        assert [_placement_tuple(p) for p in p1] == [_placement_tuple(p) for p in p2]
        assert o1 == o2

    def test_cells_never_overlap_and_respect_gap(self):
        rng = np.random.default_rng(3)
        reqs = []
        for i in range(12):
            x0, y0 = rng.integers(0, 40, 2)
            roi = (x0, y0, x0 + int(rng.integers(8, 24)), y0 + int(rng.integers(8, 24)))
            reqs.append((f"c{i:02d}", rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), roi))
        _, placements, overflow = _pack_both(dict(side=64, gap=8, max_canvases=8, min_crop=8),
                                             reqs)
        assert not overflow and len(placements) == 12
        for a in placements:
            ax0, ay0, ax1, ay1 = a.dst
            assert 0 <= ax0 < ax1 <= 64 and 0 <= ay0 < ay1 <= 64
            for b in placements:
                if a is b or a.canvas != b.canvas:
                    continue
                assert (a.dst[2] <= b.dst[0] or b.dst[2] <= a.dst[0]
                        or a.dst[3] <= b.dst[1] or b.dst[3] <= a.dst[1])

    def test_min_crop_inflation(self):
        _, placements, _ = _pack_both(dict(side=64, gap=8, max_canvases=2, min_crop=16),
                                      [("cam", _scene(), (30, 30, 33, 32))])
        (p,) = placements
        assert p.src[2] - p.src[0] == 16 and p.src[3] - p.src[1] == 16
        assert p.scale == 1

    def test_oversize_crop_decimates_power_of_two(self):
        frame = np.random.default_rng(5).integers(0, 256, (128, 128, 3), dtype=np.uint8)
        canvases, placements, _ = _pack_both(dict(side=64, gap=8, max_canvases=2, min_crop=8),
                                             [("cam", frame, (0, 0, 128, 128))])
        (p,) = placements
        assert p.scale == 2 and p.dst == (0, 0, 64, 64) and p.src == (0, 0, 128, 128)
        np.testing.assert_array_equal(canvases[0], frame[::2, ::2])

    def test_overflow_lists_unpacked_requests(self):
        reqs = [(f"c{i}", _scene(), (0, 0, 60, 60)) for i in range(4)]
        canvases, placements, overflow = _pack_both(
            dict(side=64, gap=8, max_canvases=1, min_crop=8), reqs)
        assert canvases.shape[0] == 1 and len(placements) == 1
        assert sorted(overflow) == [1, 2, 3]

    def test_area_fraction(self):
        cells = [((0, 0, 32, 32), (0, 0, 32, 32)), ((0, 0, 32, 32), (40, 0, 72, 32))]
        mine = [CropPlacement(f"s{i}", None, 0, src, dst, 1) for i, (src, dst) in enumerate(cells)]
        theirs = [jcollector.CropPlacement(f"s{i}", None, 0, src, dst, 1)
                  for i, (src, dst) in enumerate(cells)]
        frac = CanvasPacker.area_fraction(mine, 1, 64)
        assert frac == pytest.approx(2 * 32 * 32 / 64 / 64)
        assert frac == jcollector.CanvasPacker.area_fraction(theirs, 1, 64)
        assert CanvasPacker.area_fraction([], 0, 64) == 0.0


class TestPackDetectScatterRoundTrip:
    """pack -> gauge (both packages, equal outputs) -> center-point route
    -> uncrop_boxes returns every painted box exactly."""

    def _scatter(self, host, placements):
        """``_emit_canvas``'s routing: center point -> cell -> the exact
        inverse. {device_id: [(class, box)]} and the unrouted count."""
        by_canvas = {}
        for p in placements:
            by_canvas.setdefault(p.canvas, []).append(p)
        routed = {p.device_id: [] for p in placements}
        unrouted = 0
        for ci, cells in by_canvas.items():
            for cid, bx in _detections(host, ci):
                cx, cy = (bx[0] + bx[2]) / 2.0, (bx[1] + bx[3]) / 2.0
                cell = next((p for p in cells if p.contains(cx, cy)), None)
                if cell is None:
                    unrouted += 1
                    continue
                box = uncrop_boxes(np.asarray(bx, np.float32), scale=cell.scale,
                                   dst_origin=cell.dst[:2], src_origin=cell.src[:2])
                routed[cell.device_id].append((cid, [int(round(v)) for v in box]))
        return routed, unrouted

    def test_multi_stream_exact_boxes(self, gauge_steps):
        blobs = {"camA": (24, 20, 36, 30, 1), "camB": (8, 40, 28, 56, 2),
                 "camC": (30, 6, 44, 18, 4)}
        reqs = []
        for did, (x0, y0, x1, y1, key) in sorted(blobs.items()):
            roi = (max(0, x0 - 3), max(0, y0 - 3), min(64, x1 + 3), min(64, y1 + 3))
            reqs.append((did, _scene(64, 64, [(x0, y0, x1, y1, key)]), roi))
        canvases, placements, overflow = _pack_both(
            dict(side=64, gap=8, max_canvases=4, min_crop=8), reqs)
        assert not overflow
        routed, unrouted = self._scatter(gauge_steps(canvases), placements)
        assert unrouted == 0
        for did, (x0, y0, x1, y1, key) in blobs.items():
            assert routed[did] == [(key, [x0, y0, x1, y1])], did

    def test_blob_touching_crop_edge_stays_exact(self, gauge_steps):
        canvases, placements, _ = _pack_both(
            dict(side=64, gap=8, max_canvases=1, min_crop=8),
            [("cam", _scene(64, 64, [(10, 16, 30, 40, 3)]), (10, 16, 30, 40))])
        routed, unrouted = self._scatter(gauge_steps(canvases), placements)
        assert unrouted == 0
        assert routed["cam"] == [(3, [10, 16, 30, 40])]

    def test_decimated_crop_round_trips_even_boxes(self, gauge_steps):
        canvases, placements, _ = _pack_both(
            dict(side=64, gap=8, max_canvases=1, min_crop=8),
            [("cam", _scene(128, 128, [(20, 40, 48, 60, 5)]), (0, 0, 128, 128))])
        assert placements[0].scale == 2
        routed, unrouted = self._scatter(gauge_steps(canvases), placements)
        assert unrouted == 0
        assert routed["cam"] == [(5, [20, 40, 48, 60])]


class TestRoiGate:
    class _Tracker:
        def __init__(self, live):
            self.live_tracks = live

    def test_classify_table(self):
        """The JAX test's script, and a seeded random walk over every
        input, give the same verdicts from both gates."""
        gates = [_RoiGate(idle_diff=1e-4, full_interval_ms=1000),
                 jrunner._RoiGate(idle_diff=1e-4, full_interval_ms=1000)]
        now = 100.0
        script = [
            ("classify", 2, now, "full"), ("full", now), ("classify", None, now, "full"),
            ("diff", 5e-5), ("classify", 2, now, "idle"), ("diff", 1e-2),
            ("classify", 2, now, "roi"), ("classify", 0, now, "full"),
            ("classify", None, now, "full"), ("diff", 5e-5), ("classify", 2, now + 1.5, "full"),
        ]
        rng = np.random.default_rng(4)
        t = now
        for _ in range(200):
            op = rng.integers(0, 3)
            t += float(rng.uniform(0, 0.6))
            if op == 0:
                script.append(("full", t))
            elif op == 1:
                script.append(("diff", float(rng.choice([0.0, 5e-5, 1e-4, 1e-2]))))
            else:
                script.append(("classify", [None, 0, 1, 3][rng.integers(0, 4)], t, None))
        for step in script:
            if step[0] == "full":
                for g in gates:
                    g.note_full("cam", step[1])
            elif step[0] == "diff":
                for g in gates:
                    g.note_diff("cam", step[1])
            else:
                _, live, when, want = step
                tracker = None if live is None else self._Tracker(live)
                got = [g.classify("cam", tracker, when) for g in gates]
                assert got[0] == got[1], step
                if want is not None:
                    assert got[0] == want, step

    def test_dict_protocol_for_engine_gc(self):
        for gate in (_RoiGate(1e-4, 1000), jrunner._RoiGate(1e-4, 1000)):
            assert not gate and len(gate) == 0
            gate.note_diff("a", 0.5)
            gate.note_full("b", 1.0)
            assert gate and len(gate) == 2
            assert sorted(gate) == ["a", "b"]
            assert gate.pop("a") is not None
            assert gate.pop("a", "sentinel") == "sentinel"
            assert list(gate) == ["b"]


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _roi_lines(reg) -> list:
    return sorted(line for line in reg.render().splitlines()
                  if line.startswith(("vep_roi_", "vep_perf_bucket_occupancy_pct",
                                      "vep_perf_padded_slots_total", "vep_perf_fps")))


class TestPerfRoiAttribution:
    def _both(self):
        clk = _FakeClock()
        regs = (metrics.Registry(), jmetrics.Registry())
        return clk, regs, (PerfTracker(registry=regs[0], peak_tflops=100.0, clock=clk),
                           JPerfTracker(registry=regs[1], peak_tflops=100.0, clock=clk))

    def test_canvas_aware_note_batch(self):
        clk, regs, trackers = self._both()
        for p in trackers:
            p.note_batch("m", (64, 64), 4, 10.0, 2, streams=9, area_frac=0.42)
        fam = {f.name: f for f in regs[0].families()}
        assert fam["vep_perf_bucket_occupancy_pct"].labels("m", "4").value == pytest.approx(42.0)
        assert fam["vep_perf_padded_slots_total"].labels("m", "4").value == 2
        clk.advance(1.0)
        for p in trackers:
            p.note_batch("m", (64, 64), 4, 10.0, 2, streams=9, area_frac=0.42)
        assert trackers[0].fps() == pytest.approx(18.0) == trackers[1].fps()
        assert _roi_lines(regs[0]) == _roi_lines(regs[1])

    def test_note_batch_without_kwargs_keeps_slot_occupancy(self):
        _, regs, trackers = self._both()
        for p in trackers:
            p.note_batch("m", (64, 64), 4, 10.0, 3)
        fam = {f.name: f for f in regs[0].families()}
        assert fam["vep_perf_bucket_occupancy_pct"].labels("m", "4").value == pytest.approx(75.0)
        assert _roi_lines(regs[0]) == _roi_lines(regs[1])

    def test_roi_counters_and_snapshot_section(self):
        import json

        clk, regs, trackers = self._both()
        assert all("roi" not in p.snapshot() for p in trackers)
        for p in trackers:
            p.note_roi_gate(idle=3, roi=2, full=1)
            p.note_roi_pack(crops=4, canvases=2, area_frac=0.5)
            p.note_roi_emit(2)
        clk.advance(1.0)
        for p in trackers:
            p.note_roi_emit(4)
            p.note_roi_unrouted()
        fam = {f.name: f for f in regs[0].families()}
        assert fam["vep_roi_stream_states_total"].labels("idle").value == 3
        assert fam["vep_roi_crops_total"].labels().value == 4
        assert fam["vep_roi_canvas_occupancy_pct"].labels().value == 50.0
        assert fam["vep_roi_unrouted_total"].labels().value == 1
        roi = trackers[0].snapshot()["roi"]
        json.dumps(roi)
        assert roi == trackers[1].snapshot()["roi"]
        assert roi["stream_ticks"] == {"idle": 3, "roi": 2, "full": 1}
        assert roi["gated_stream_pct"] == pytest.approx(83.3)
        assert roi["crops_per_canvas"] == 2.0 and roi["unrouted"] == 1
        assert roi["equivalent_fps"] == pytest.approx(6.0)
        assert _roi_lines(regs[0]) == _roi_lines(regs[1])
        assert metrics.lint_exposition(regs[0].render()) == []


# -- the engine, hand-stepped (tests/test_roi.py's _tick convention) -------------


class _Pair:
    """One hand-stepped tiny_blob_gauge engine of each package on buses of
    their own, fed the same frames."""

    def __init__(self, roi=True, **cfg_kw):
        if roi:
            cfg_kw.setdefault("roi_full_interval_ms", 600_000)
            cfg_kw.update(roi=True, roi_canvas=64, roi_min_crop=8)
        base = dict(model="tiny_blob_gauge", batch_buckets=(1, 2, 4), tick_ms=5,
                    prefetch=False, **cfg_kw)
        self.bus, self.jbus = MemoryFrameBus(), JMemoryFrameBus()
        self.eng = InferenceEngine(self.bus, EngineConfig(**base), device="cpu",
                                   annotations=AnnotationQueue(handler=lambda b: True))
        self.jeng = jrunner.InferenceEngine(
            self.jbus, JEngineConfig(**base),
            annotations=JAnnotationQueue(handler=lambda b: True))
        self.subs = []
        for e in (self.eng, self.jeng):
            e.warmup()
            # Full, canvas and coast groups can leave one tick; both ends
            # run on the test thread.
            e._drain_q = queue.Queue(maxsize=8)
            q = queue.Queue()
            with e._sub_lock:
                e._subscribers.append((q, None))
            self.subs.append(q)

    def close(self):
        for e in (self.eng, self.jeng):
            e._drain_q.join()
        self.bus.close()
        self.jbus.close()

    def create(self, did):
        self.bus.create_stream(did, 64 * 64 * 3)
        self.jbus.create_stream(did, 64 * 64 * 3)

    def publish(self, did, frame, ts):
        self.bus.publish(did, frame, _meta(ts=ts))
        self.jbus.publish(did, frame, _meta(ts=ts, cls=JFrameMeta))

    def steer(self, did, diff):
        self.eng._roi.state(did)["diff"] = diff
        self.jeng._roi.state(did)["diff"] = diff

    def tick(self, checksums=None):
        """One tick of each engine; their results as comparable tuples."""
        out = []
        for e, q, cs in ((self.eng, self.subs[0], checksum), (self.jeng, self.subs[1], jchecksum)):
            groups = e._collector.collect()
            if e._roi is not None:
                groups = e._roi_transform(groups)
            e._dispatch(groups, time.time())
            while True:
                try:
                    inflight = e._drain_q.get_nowait()
                except queue.Empty:
                    break
                try:
                    if checksums is not None and inflight.outputs:
                        checksums[e is self.jeng].append(int(np.asarray(
                            cs.device_checksum(inflight.outputs))))
                    e._emit(inflight)
                finally:
                    e._collector.release(inflight.group)
                    e._drain_q.task_done()
            results = []
            while not q.empty():
                r = q.get_nowait()
                results.append((r.device_id, r.timestamp, r.batch_size, [
                    ((d.box.left, d.box.top, d.box.left + d.box.width, d.box.top + d.box.height),
                     d.class_id, float(d.confidence), d.track_id)
                    for d in r.detections]))
            out.append(results)
        # Box for box, id for id; confidences to float32 (the JAX results
        # are protobuf messages, whose confidence field is a float32).
        strip = [[(r[:3], [(d[0], d[1], d[3]) for d in r[3]]) for r in res] for res in out]
        assert strip[0] == strip[1]
        conf = [[d[2] for r in res for d in r[3]] for res in out]
        np.testing.assert_allclose(conf[0], conf[1], rtol=1e-6)
        return out[0]


BLOB_A = (24, 20, 36, 30)   # xyxy, color key 1
BLOB_B = (8, 40, 28, 56)    # xyxy, color key 2


class TestRoiEngine:
    def test_full_roi_idle_transitions_exact_parity(self):
        """One stream through the three verdicts, then a seeded walk of
        the steered diff over moving blobs: the port's results equal the
        JAX engine's, box for box, each tick; packed and coasted results
        carry the full frame's box, routed to their stream, none
        unrouted."""
        pair = _Pair()
        try:
            pair.create("camA")
            blob = [BLOB_A + (1,)]
            pair.publish("camA", _scene(blobs=blob), 1000)
            (r1,) = pair.tick()
            assert r1[0] == "camA" and r1[3][0][:2] == (BLOB_A, 1) and r1[3][0][3] != ""
            assert pair.eng._roi.state("camA")["full_at"] > 0
            pair.steer("camA", 1.0)
            pair.publish("camA", _scene(blobs=blob), 1001)
            (r2,) = pair.tick()
            assert r2[0] == "camA" and r2[3][0][:2] == (BLOB_A, 1)
            assert r2[3][0][2] == pytest.approx(float(jax.nn.sigmoid(8.0)), rel=1e-4)
            batches = pair.eng.pipeline_stats().batches
            pair.steer("camA", 0.0)
            pair.publish("camA", _scene(blobs=blob), 1002)
            (r3,) = pair.tick()
            assert pair.eng.pipeline_stats().batches == batches   # no device batch ran
            assert r3[3][0][:2] == (BLOB_A, 1) and r3[3][0][3] == r1[3][0][3]
            assert r3[3][0][2] == pytest.approx(
                float(jax.nn.sigmoid(8.0)) * pair.eng._cfg.roi_coast_decay, rel=1e-4)
            snap = pair.eng.perf.snapshot()["roi"]
            assert snap["unrouted"] == 0 and snap["crops"] == 1
            assert snap["stream_ticks"] == {"idle": 1, "roi": 1, "full": 1}
            # A scripted walk: the blob moves a few px a tick, the diff
            # steers full / roi / idle verdicts.
            rng = np.random.default_rng(9)
            x0, y0 = 24, 20
            for t in range(12):
                x0 = int(np.clip(x0 + rng.integers(-3, 4), 4, 44))
                y0 = int(np.clip(y0 + rng.integers(-3, 4), 4, 44))
                pair.steer("camA", float(rng.choice([0.0, 1.0])))
                pair.publish("camA", _scene(blobs=[(x0, y0, x0 + 12, y0 + 10, 1)]), 1003 + t)
                assert len(pair.tick()) == 1
            mine, theirs = (dict(e.perf.snapshot()["roi"]) for e in (pair.eng, pair.jeng))
            for snap in (mine, theirs):
                snap.pop("equivalent_fps")   # a rate over each engine's own clock
            assert mine == theirs
        finally:
            pair.close()

    def test_two_streams_share_canvas_no_cross_talk(self):
        pair = _Pair()
        try:
            scenes = {"camA": [BLOB_A + (1,)], "camB": [BLOB_B + (2,)]}
            for did in scenes:
                pair.create(did)
            for did, blobs in scenes.items():
                pair.publish(did, _scene(blobs=blobs), 2000)
            assert sorted(r[0] for r in pair.tick()) == ["camA", "camB"]
            for did, blobs in scenes.items():
                pair.steer(did, 1.0)
                pair.publish(did, _scene(blobs=blobs), 2001)
            r2 = {r[0]: r for r in pair.tick()}
            assert r2["camA"][3][0][:2] == (BLOB_A, 1)
            assert r2["camB"][3][0][:2] == (BLOB_B, 2)
            snap = pair.eng.perf.snapshot()["roi"]
            assert snap["unrouted"] == 0 and snap["crops"] == 2
            assert snap["canvases"] == 1   # shared, not one each
        finally:
            pair.close()

    def test_roi_off_is_structurally_inert(self):
        """roi=False (the kill switch): no gate, no packer, no ROI state on
        the engine, and a tick runs the classic path only."""
        bus = MemoryFrameBus()
        try:
            eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge",
                                                    batch_buckets=(1, 2, 4), tick_ms=5,
                                                    prefetch=False), device="cpu",
                                  annotations=AnnotationQueue(handler=lambda b: True))
            eng.warmup()
            assert eng._roi is None and eng._packer is None and not eng._roi_mode
            called = []
            eng._roi_transform = lambda groups: called.append(groups) or groups
            bus.create_stream("cam", 64 * 64 * 3)
            bus.publish("cam", _scene(blobs=[BLOB_A + (1,)]), _meta())
            eng._tick(0.005)
            assert not called and "roi" not in eng.perf.snapshot()
        finally:
            bus.close()

    def test_roi_on_full_path_bit_identical_checksum(self):
        """Detect-less scenes never gate, so an ROI engine folds the same
        device checksum as roi=False over the same frames, in both
        packages, and the two packages' folds are equal."""
        folds = {}
        for roi in (True, False):
            pair = _Pair(roi=roi)
            try:
                pair.create("cam1")
                checksums = ([], [])
                for ts, value in enumerate((15, 60, 105, 150)):
                    pair.publish("cam1", np.full((64, 64, 3), value, np.uint8), 3000 + ts)
                    pair.tick(checksums)
                folds[roi] = tuple(jchecksum.finalize_checksum(
                    sum(c) & jchecksum.CHECKSUM_MASK) for c in checksums)
            finally:
                pair.close()
        assert folds[True] == folds[False]
        assert folds[True][0] == folds[True][1]

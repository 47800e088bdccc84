"""The temporal cascade of the port (``temporal/``: ``TrackStatePool``,
``TrackEventTracker``, ``CascadeScheduler``; the engine's
``_build_cascade_head``, ``_cascade_tick``, the harvest tap and the event
fan-out; ``ingest/archive.py``; ``/api/v1/cascade``) against the JAX
package's, test for test with ``tests/test_cascade.py`` but its mesh test.

- The state pool: the same operations on both pools give the same gathers
  (numpy-seeded tiles), the same slots, cursors and high water.
- The event hysteresis and the scheduler (a scripted head): the same
  events, head ticks and snapshots, call for call.
- The head: ``tiny_videomae``'s ``event_score``, ``features`` and
  ``logits`` from the same flax weights (``from_flax``), float32, within
  ``RTOL = ATOL = 2e-4``.
- The engine, hand-stepped (the JAX test's ``_tick``: collect, dispatch,
  drain with the harvest tap, cascade tick) on ``tiny_blob_gauge`` scenes
  whose "anomalous" blob flickers its blue channel +-15 a frame: the same
  uplink events, archive segments, head cadence and pool occupancy as the
  JAX engine's; the device checksum unchanged with the cascade on; the
  pool never read back to the host.
- The REST route: 400 with the cascade off, the JAX server's keys with it
  on.

The card-only cases are in ``tests/test_torch_cuda_roi_cascade.py``.
"""

import json
import queue
import time
import urllib.error
import urllib.request

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu import temporal as jtemporal
from video_edge_ai_proxy_tpu.bus.interface import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.ingest import archive as jarchive
from video_edge_ai_proxy_tpu.models import videomae as jvmae
from video_edge_ai_proxy_tpu.proto import pb
from video_edge_ai_proxy_tpu.replay import checksum as jchecksum
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import (
    BoundingBox, Detection, InferenceEngine, _build_cascade_head,
)
from video_edge_ai_proxy_tpu_torch.ingest import archive
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import load_flax
from video_edge_ai_proxy_tpu_torch.replay import checksum
from video_edge_ai_proxy_tpu_torch.temporal import (
    CascadeScheduler, TrackEventTracker, TrackStatePool,
)
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

RTOL = ATOL = 2e-4


def _meta(w=64, h=64, ts=None, cls=FrameMeta):
    return cls(width=w, height=h, channels=3, timestamp_ms=ts or int(time.time() * 1000),
               is_keyframe=True)


def _blob_frame(delta=0, box=(20, 20, 40, 40), key=1, h=64, w=64):
    """Gray frame with one color-keyed blob; ``delta`` shifts its blue
    channel (a luma flicker that leaves the red class bin alone)."""
    frame = np.full((h, w, 3), 114, np.uint8)
    x0, y0, x1, y1 = box
    frame[y0:y1, x0:x1] = (64 + delta, 255, key * 32 + 16)
    return frame


def _det(track_id, box=(20, 20, 40, 40), class_id=1):
    x0, y0, x1, y1 = box
    return Detection(box=BoundingBox(left=x0, top=y0, width=x1 - x0, height=y1 - y0),
                     class_id=class_id, confidence=0.9, track_id=str(track_id))


def _jdet(track_id, box=(20, 20, 40, 40), class_id=1):
    x0, y0, x1, y1 = box
    return pb.Detection(box=pb.BoundingBox(left=x0, top=y0, width=x1 - x0, height=y1 - y0),
                        class_id=class_id, confidence=0.9, track_id=str(track_id))


# -- the state pool ------------------------------------------------------------------


class _Pools:
    """One pool of each package, driven by the same calls."""

    def __init__(self, side, clip_len):
        self.mine = TrackStatePool(side=side, clip_len=clip_len, device="cpu")
        self.theirs = jtemporal.TrackStatePool(side=side, clip_len=clip_len)

    def scatter(self, keys, tiles, bucket=None):
        a = self.mine.scatter(keys, tiles, bucket=bucket)
        assert a == self.theirs.scatter(keys, tiles, bucket=bucket)
        return a

    def pop(self, key):
        row = self.mine.pop(key)
        assert row == self.theirs.pop(key)
        return row

    def gather(self, keys, bucket):
        plan = self.mine.gather_indices(keys, bucket)
        jplan = self.theirs.gather_indices(keys, bucket)
        for a, b in zip(plan, jplan):
            np.testing.assert_array_equal(a, b)
        clips = self.mine.gather(*plan).numpy()
        np.testing.assert_array_equal(clips, np.asarray(self.theirs.gather(*jplan)))
        assert self.mine.high_water == self.theirs.high_water
        assert len(self.mine) == len(self.theirs)
        return clips


class TestTrackStatePool:
    def _tiles(self, n, side=8, value=0):
        return np.full((n, side, side, 3), value, np.uint8)

    def test_slot_assign_free_reuse_and_row0_reserved(self):
        pools = _Pools(8, 2)
        pools.scatter(["a"], self._tiles(1, value=10))
        pools.scatter(["b"], self._tiles(1, value=20))
        assert len(pools.mine) == 2 and "a" in pools.mine and "b" in pools.mine
        assert pools.mine.high_water == 2
        assert pools.pop("a") == 1 and len(pools.mine) == 1
        pools.scatter(["c"], self._tiles(1, value=30))
        assert pools.mine.high_water == 2
        assert int(pools.mine.array[0].max()) == 0
        pools.gather(["b", "c"], 4)

    def test_gather_is_time_ordered_oldest_first(self):
        pools = _Pools(4, 3)
        for v in (1, 2, 3, 4, 5):
            pools.scatter(["t"], self._tiles(1, side=4, value=v))
        assert pools.mine.full("t") and pools.theirs.full("t")
        clips = pools.gather(["t"], 4)
        assert clips.shape == (4, 3, 4, 4, 3)
        assert [int(clips[0, j, 0, 0, 0]) for j in range(3)] == [3, 4, 5]
        assert clips[1:].max() == 0

    def test_growth_preserves_content(self):
        pools = _Pools(4, 2)
        pools.scatter(["keep"], self._tiles(1, side=4, value=99))
        pools.scatter(["keep"], self._tiles(1, side=4, value=98))
        rng = np.random.default_rng(2)
        for i in range(12):
            pools.scatter([f"t{i}"], rng.integers(0, 256, (1, 4, 4, 3), dtype=np.uint8))
        assert pools.mine.array.shape[0] > 8
        assert pools.mine.nbytes() == int(np.asarray(pools.theirs.array).nbytes)
        clips = pools.gather(["keep"] + [f"t{i}" for i in range(7)], 8)
        assert [int(clips[0, j, 0, 0, 0]) for j in range(2)] == [99, 98]

    def test_full_requires_clip_len_frames(self):
        pools = _Pools(4, 3)
        for i in range(2):
            pools.scatter(["t"], self._tiles(1, side=4, value=i))
            assert not pools.mine.full("t") and not pools.theirs.full("t")
        pools.scatter(["t"], self._tiles(1, side=4, value=9))
        assert pools.mine.full("t") and pools.theirs.full("t")

    def test_bucketed_scatter_pads_by_repeating_last(self):
        """The bucket pads by repeating the last entry: a duplicate write
        of the same bytes to one cell, harmless. Seeded churn through both
        pools (scatters of 1-5 tracks in buckets, pops) keeps every gather
        equal."""
        pools = _Pools(4, 2)
        assert pools.scatter(["a", "b"], self._tiles(2, side=4, value=5), bucket=4) == 2 * 4 * 4
        assert len(pools.mine) == 2
        pools.scatter(["a", "b"], self._tiles(2, side=4, value=6), bucket=4)
        assert pools.mine.full("a") and pools.mine.full("b")
        rng = np.random.default_rng(7)
        live = {"a", "b"}
        for step in range(30):
            keys = sorted(rng.choice([f"k{i}" for i in range(9)], rng.integers(1, 6),
                                     replace=False))
            pools.scatter(list(keys), rng.integers(0, 256, (len(keys), 4, 4, 3), dtype=np.uint8),
                          bucket=8)
            live |= set(keys)
            if step % 4 == 3:
                pools.pop(sorted(live)[rng.integers(0, len(live))])
                live = set(pools.mine)
            pools.gather(sorted(pools.mine), 16)


# -- the event hysteresis -------------------------------------------------------------


class TestTrackEventTracker:
    def _both(self, **kw):
        return TrackEventTracker(**kw), jtemporal.TrackEventTracker(**kw)

    def _observe(self, pair, key, score):
        got = [ev.observe(key, score) for ev in pair]
        assert got[0] == got[1]
        return got[0]

    def test_enter_exit_fire_exactly_once(self):
        pair = self._both(threshold=0.5, enter_n=2, exit_n=2)
        assert self._observe(pair, "t", 0.9) is None
        assert self._observe(pair, "t", 0.9) == "enter"
        for _ in range(5):
            assert self._observe(pair, "t", 0.9) is None
        assert pair[0].active("t")
        assert self._observe(pair, "t", 0.1) is None
        assert self._observe(pair, "t", 0.1) == "exit"
        assert not pair[0].active("t")
        rng = np.random.default_rng(3)
        for _ in range(300):
            key = f"t{rng.integers(0, 3)}"
            self._observe(pair, key, float(rng.uniform()))
            assert pair[0].active_keys() == pair[1].active_keys()

    def test_flap_resets_run_and_fires_nothing(self):
        pair = self._both(threshold=0.5, enter_n=3, exit_n=2)
        for _ in range(4):
            assert self._observe(pair, "t", 0.9) is None
            assert self._observe(pair, "t", 0.9) is None
            assert self._observe(pair, "t", 0.1) is None
        assert not pair[0].active("t") and not pair[1].active("t")

    def test_pop_restarts_cold_without_event(self):
        pair = self._both(enter_n=1, exit_n=1)
        assert self._observe(pair, "t", 0.9) == "enter"
        assert all(ev.pop("t") is not None for ev in pair)
        assert "t" not in pair[0] and len(pair[0]) == len(pair[1]) == 0
        assert self._observe(pair, "t", 0.9) == "enter"


# -- the scheduler --------------------------------------------------------------------


def _scripted_head(score, calls):
    """The engine's head stand-in: a constant score, each dispatch recorded."""

    def head(pool, slot_idx, time_idx, n_real):
        bucket = int(slot_idx.shape[0])
        calls.append({"bucket": bucket, "n_real": n_real,
                      "slots": [int(s) for s in slot_idx[:n_real]]})
        return {"event_score": np.full((bucket,), score, np.float32),
                "features": np.zeros((bucket, 3), np.float32),
                "logits": np.zeros((bucket, 2), np.float32)}, 0.5

    return head


class _Scheds:
    """One scheduler of each package, the same scripted head score."""

    def __init__(self, score=0.9, **kw):
        kw.setdefault("model", "tiny_videomae")   # side 32, clip_len 4
        kw.setdefault("every_n", 3)
        self.mine = CascadeScheduler(device="cpu", **kw)
        self.theirs = jtemporal.CascadeScheduler(**kw)
        self.calls = ([], [])
        self.mine.head = _scripted_head(score, self.calls[0])
        self.theirs.head = _scripted_head(score, self.calls[1])

    def harvest(self, stream, frame, tracks):
        n = self.mine.harvest(stream, frame, [_det(t, box, c) for t, box, c in tracks], _meta())
        assert n == self.theirs.harvest(stream, frame, [_jdet(t, box, c) for t, box, c in tracks],
                                        _meta(cls=JFrameMeta))

    def tick(self):
        res = self.mine.tick()
        jres = self.theirs.tick()
        strip = lambda evs: [{k: v for k, v in e.items() if k not in ("meta", "history")}
                             for e in evs]   # noqa: E731
        assert strip(res.events) == strip(jres.events)
        assert [s for s, _ in res.head_tracks] == [s for s, _ in jres.head_tracks]
        assert self.calls[0] == self.calls[1]
        assert self.snapshot() is not None
        return res

    def snapshot(self):
        snap = self.mine.snapshot()
        assert snap == self.theirs.snapshot()
        return snap


class TestCascadeScheduler:
    def test_head_runs_at_exact_cadence_with_full_clips_only(self):
        scheds = _Scheds()
        frame = _blob_frame()
        for _ in range(12):
            scheds.harvest("camA", frame, [(1, (20, 20, 40, 40), 1)])
            scheds.tick()
        assert list(scheds.mine.head_ticks) == [6, 9, 12]
        assert scheds.mine.head_dispatches == 3
        assert all(c["n_real"] == 1 and c["bucket"] == 4 for c in scheds.calls[0])
        snap = scheds.snapshot()
        assert snap["ticks"] == 12 and snap["head_dispatches"] == 3
        assert snap["tracks"]["camA#1"]["observed"] == 3
        # The pools' tiles and clips agree too.
        plan = scheds.mine._pool.gather_indices(["camA#1"], 4)
        np.testing.assert_array_equal(
            scheds.mine._pool.gather(*plan).numpy(),
            np.asarray(scheds.theirs._pool.gather(*plan)))

    def test_ttl_expiry_frees_slot_and_reuses_it(self):
        scheds = _Scheds(ttl_ticks=2)
        frame = _blob_frame()
        scheds.harvest("camA", frame, [(1, (20, 20, 40, 40), 1)])
        scheds.tick()
        assert scheds.snapshot()["slots_in_use"] == 1
        for _ in range(3):
            scheds.tick()
        snap = scheds.snapshot()
        assert snap["slots_in_use"] == 0 and not snap["tracks"]
        scheds.harvest("camA", frame, [(2, (20, 20, 40, 40), 1)])
        scheds.tick()
        assert scheds.snapshot()["slot_high_water"] == 1

    def test_pop_stream_drops_all_its_tracks_without_events(self):
        scheds = _Scheds(every_n=1, enter_n=1)
        frame = _blob_frame()
        for _ in range(4):
            scheds.harvest("camA", frame, [(1, (20, 20, 40, 40), 1)])
            scheds.harvest("camB", frame, [(1, (20, 20, 40, 40), 1)])
            res = scheds.tick()
        assert sorted(scheds.mine) == sorted(scheds.theirs) == ["camA", "camB"]
        before = dict(scheds.snapshot()["event_counts"])
        assert scheds.mine.pop("camA") == scheds.theirs.pop("camA")
        assert sorted(scheds.mine) == ["camB"]
        snap = scheds.snapshot()
        assert snap["slots_in_use"] == 1
        assert all(k.startswith("camB#") for k in snap["tracks"])
        assert snap["event_counts"] == before
        assert res is not None


# -- the head --------------------------------------------------------------------------


def _videomae_weights():
    """flax init of the f32 tiny VideoMAE with every bias and embedding
    drawn from a numpy seed, unboxed, as numpy."""
    v = jax.jit(jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)))
    rng = np.random.default_rng(0)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(val, path + (k,)) for k, val in node.items()}
        if path[-1] in ("bias", "pos_embed", "cls_token"):
            return rng.normal(0.0, 0.2, node.shape).astype(np.float32)
        return np.asarray(node, np.float32)
    return walk(fnn.meta.unbox(v), ())


def test_cascade_head_equals_jax_f32():
    """``_build_cascade_head`` against the JAX one on tiny_videomae in
    float32 from the same flax weights: a flickering clip, a static one
    (its diff-energy feature exactly 0), random clips and the all-zero
    padded slot."""
    variables = _videomae_weights()
    jmodel = jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=jnp.float32)
    model = load_flax(registry.get("tiny_videomae").build(torch.float32), variables).eval()
    w, b = (2000.0, 0.5, 3.0), -4.0
    rng = np.random.default_rng(5)
    clips = rng.integers(0, 256, (4, 4, 32, 32, 3), dtype=np.uint8)
    clips[1] = clips[1, :1]                                  # static
    clips[2] = np.full((32, 32, 3), 114, np.uint8)
    clips[2, ::2, 8:24, 8:24] = (79, 255, 48)               # blue flicker
    clips[2, 1::2, 8:24, 8:24] = (49, 255, 48)
    clips[3] = 0                                             # a padded slot
    got = _build_cascade_head(model, w, b)(torch.from_numpy(clips))
    want = jrunner._build_cascade_head(jmodel, w, b)(variables, jnp.asarray(clips))
    for k in ("event_score", "features", "logits"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert float(got["features"][1, 0]) == 0.0 and float(got["features"][3, 1]) == 0.0
    assert float(got["event_score"][2]) > 0.5 > float(got["event_score"][1])


# -- the engine, hand-stepped ------------------------------------------------------------


class _AnnSink:
    def __init__(self):
        self.items = []

    def publish(self, payload):
        self.items.append(payload)


class _ArchiveStub:
    """``ingest/archive.py`` ``SegmentArchiver`` duck type (submit only)."""

    def __init__(self):
        self.segments = []

    def submit(self, seg):
        self.segments.append(seg)


def _cfg(cls, cascade=True, **kw):
    base = dict(model="tiny_blob_gauge", batch_buckets=(1, 2, 4), tick_ms=5, prefetch=False,
                track=True)
    if cascade:
        base.update(cascade=True, cascade_model="tiny_videomae", cascade_every_n=2)
    base.update(kw)
    return cls(**base)


class _Engines:
    """A hand-stepped cascade engine of each package on buses of their
    own, fed the same frames and stamps."""

    def __init__(self, cascade=True, **kw):
        self.bus, self.jbus = MemoryFrameBus(), JMemoryFrameBus()
        self.ann, self.jann = _AnnSink(), _AnnSink()
        self.arch, self.jarch = _ArchiveStub(), _ArchiveStub()
        self.eng = InferenceEngine(self.bus, _cfg(EngineConfig, cascade, **kw), device="cpu",
                                   annotations=self.ann, archiver=self.arch)
        self.jeng = jrunner.InferenceEngine(self.jbus, _cfg(JEngineConfig, cascade, **kw),
                                            annotations=self.jann, archiver=self.jarch)
        for e in (self.eng, self.jeng):
            e.warmup()
            e._drain_q = queue.Queue(maxsize=8)
            q = queue.Queue()
            with e._sub_lock:
                e._subscribers.append((q, None))
        self.folds = ([], [])

    def close(self):
        self.bus.close()
        self.jbus.close()

    def create(self, did):
        self.bus.create_stream(did, 64 * 64 * 3)
        self.jbus.create_stream(did, 64 * 64 * 3)

    def publish(self, did, frame, ts):
        self.bus.publish(did, frame, _meta(ts=ts))
        self.jbus.publish(did, frame, _meta(ts=ts, cls=JFrameMeta))

    def tick(self):
        """collect -> dispatch -> drain/emit (the harvest tap) -> cascade
        tick, as the JAX test's ``_tick``, on each engine; the device
        checksum of each batch folds into ``folds``."""
        for k, (e, cs) in enumerate(((self.eng, checksum), (self.jeng, jchecksum))):
            groups = e._collector.collect()
            e._dispatch(groups, time.time())
            while True:
                try:
                    inflight = e._drain_q.get_nowait()
                except queue.Empty:
                    break
                try:
                    self.folds[k].append(int(np.asarray(cs.device_checksum(inflight.outputs))))
                    e._emit(inflight)
                finally:
                    e._collector.release(inflight.group)
                    e._drain_q.task_done()
            if e._cascade is not None:
                e._cascade_tick()

    def requests(self):
        """The uplink's cascade events of each package, decoded by the
        protobuf message: (device, type, track id, model, version,
        confidence) per event."""
        out = []
        for items in (self.ann.items, self.jann.items):
            reqs = [pb.AnnotateRequest.FromString(p) for p in items]
            out.append([(r.device_name, r.object_type, r.object_tracking_id, r.ml_model,
                         r.ml_model_version, r.start_timestamp, r.confidence)
                        for r in reqs if r.type == "cascade"])
        assert [r[:-1] for r in out[0]] == [r[:-1] for r in out[1]]
        # The scores to the head's bound: XLA's CPU logistic is a few f32
        # ulps from sigmoid(-4) on a static clip.
        np.testing.assert_allclose([r[-1] for r in out[0]], [r[-1] for r in out[1]],
                                   rtol=RTOL, atol=ATOL)
        return out[0]


class TestCascadeEngine:
    def test_cascade_off_is_structurally_inert(self):
        """cascade=False (the default): no scheduler, no pool, no head
        program, and a tick never reaches a cascade branch."""
        bus = MemoryFrameBus()
        try:
            eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge",
                                                    batch_buckets=(1, 2), tick_ms=5),
                                  device="cpu", annotations=_AnnSink())
            assert eng._cascade is None and eng.cascade is None
            called = []
            eng._cascade_tick = lambda: called.append(1)
            bus.create_stream("cam", 64 * 64 * 3)
            bus.publish("cam", _blob_frame(), _meta())
            eng._tick(0.005)
            assert not called
            assert not any(k[0].startswith("cascade:") for k in eng._steps)
            assert "cascade" not in eng.perf.snapshot()
        finally:
            bus.close()

    def test_cascade_on_emitted_checksum_bit_identical(self):
        """A pure tap: with flickering tracked blobs the detect outputs fold
        the same device checksum with the cascade on (the head running) as
        off, and equal to the JAX engine's."""
        folds = {}
        for cascade in (True, False):
            eng = _Engines(cascade=cascade)
            try:
                eng.create("cam1")
                for f in range(8):
                    eng.publish("cam1", _blob_frame(15 if f % 2 == 0 else -15), 5000 + f)
                    eng.tick()
                if cascade:
                    assert eng.eng._cascade.head_dispatches == eng.jeng._cascade.head_dispatches > 0
                folds[cascade] = tuple(jchecksum.finalize_checksum(
                    sum(f) & jchecksum.CHECKSUM_MASK) for f in eng.folds)
            finally:
                eng.close()
        assert folds[True] == folds[False]
        assert folds[True][0] == folds[True][1]

    def test_event_fanout_uplink_archive_metrics_exactly_once(self, monkeypatch):
        """A flickering blob enters (one uplink request, one archive
        segment), goes static and exits (one more request, no segment); a
        static blob on a second stream never fires; the same as the JAX
        engine's, event for event. The pool tensor never crosses to the
        host while this runs."""
        eng = _Engines()
        try:
            for did in ("camA", "camB"):
                eng.create(did)
            sched = eng.eng._cascade

            def guard(name):
                real = getattr(torch.Tensor, name)

                def checked(self, *a, **kw):
                    pool = sched._pool.array if sched._pool is not None else None
                    if pool is not None:
                        assert (self.untyped_storage().data_ptr()
                                != pool.untyped_storage().data_ptr()), "state pool read back"
                    return real(self, *a, **kw)
                return checked

            for name in ("numpy", "cpu", "tolist"):
                monkeypatch.setattr(torch.Tensor, name, guard(name))
            for f in range(16):
                delta = (15 if f % 2 == 0 else -15) if f < 8 else 15
                eng.publish("camA", _blob_frame(delta, key=1), 6000 + f)
                eng.publish("camB", _blob_frame(0, key=2), 6000 + f)
                eng.tick()
            monkeypatch.undo()
            casc = eng.requests()
            enters = [r for r in casc if r[1] == "anomaly_enter"]
            exits = [r for r in casc if r[1] == "anomaly_exit"]
            assert len(enters) == 1 and len(exits) == 1
            assert enters[0][0] == "camA" and enters[0][2] != ""
            assert enters[0][3:5] == ("temporal.cascade", "tiny_videomae")
            assert enters[0][-1] > 0.5 > exits[0][-1]
            assert all(r[0] == "camA" for r in casc)
            for segs in (eng.arch.segments, eng.jarch.segments):
                assert len(segs) == 1
            seg, jseg = eng.arch.segments[0], eng.jarch.segments[0]
            assert seg.device_id == jseg.device_id == "cascade_camA"
            assert (seg.start_ts_ms, seg.end_ts_ms, seg.fps) == (jseg.start_ts_ms, jseg.end_ts_ms,
                                                                 jseg.fps)
            assert seg.frames[0].shape == (32, 32, 3) and seg.end_ts_ms > seg.start_ts_ms
            for a, b in zip(seg.frames, jseg.frames, strict=True):
                np.testing.assert_array_equal(a, b)
            hts = list(sched.head_ticks)
            assert hts == list(eng.jeng._cascade.head_ticks)
            assert hts and all(b - a == 2 for a, b in zip(hts, hts[1:]))
            snap = eng.eng.perf.snapshot()["cascade"]
            assert snap == eng.jeng.perf.snapshot()["cascade"]
            assert snap["ticks"] == 16 and snap["events"] == {"enter": 1, "exit": 1}
            assert snap["head_batches"] == len(hts) and snap["slot_high_water"] == 2
            api = sched.snapshot()
            assert api["event_counts"] == {"enter": 1, "exit": 1}
            assert json.dumps(api["events"])
        finally:
            eng.close()

    def test_track_churn_conserves_pool_slots(self):
        """Tracks that expire (TTL) hand their rows back: the high water
        stays bounded by the peak number of concurrent tracks across churn
        waves, in both packages alike."""
        eng = _Engines(cascade_track_ttl_ticks=2)
        try:
            eng.create("camA")
            frame = _blob_frame()
            t = 7000
            for _wave in range(3):
                for _ in range(2):
                    eng.publish("camA", frame, t)
                    eng.tick()
                    t += 1
                for _ in range(4):
                    eng.publish("camA", np.full((64, 64, 3), 114, np.uint8), t)
                    eng.tick()
                    t += 1
            snaps = [e._cascade.snapshot() for e in (eng.eng, eng.jeng)]
            assert snaps[0]["slot_high_water"] <= 2
            for k in ("slot_high_water", "slots_in_use", "harvested", "head_ticks",
                      "event_counts"):
                assert snaps[0][k] == snaps[1][k], k
        finally:
            eng.close()


def test_segment_archiver_writes_the_jax_layout(tmp_path):
    """The decoded-frame archive: the same file names under the same
    directories as the JAX archiver (``<start>_<duration>``, a ``-n``
    suffix for a second segment of one millisecond), by the same encoder
    route (OpenCV when it imports, else ``.npz``); an empty
    ``PacketGopSegment`` (the compressed archive's segment) is skipped by
    both, as an empty ``GopSegment`` is."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(6)]
    layouts = []
    for mod, root in ((archive, tmp_path / "port"), (jarchive, tmp_path / "jax")):
        arch = mod.SegmentArchiver(str(root))
        arch.start()
        for _ in range(2):
            arch.submit(mod.GopSegment(device_id="cascade_camA", start_ts_ms=1000,
                                       end_ts_ms=1200, fps=30.0, frames=frames))
        arch.submit(mod.GopSegment(device_id="camB", start_ts_ms=5, end_ts_ms=5, fps=10.0,
                                   frames=frames[:3]))
        deadline = time.monotonic() + 20
        while arch.written < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        arch.stop()
        assert arch.written == 3
        layouts.append(sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()))
    assert layouts[0] == layouts[1]
    assert any(name.startswith("camB/5_300") for name in layouts[0])
    for mod, root in ((archive, tmp_path / "port_empty"), (jarchive, tmp_path / "jax_empty")):
        mod.SegmentArchiver(str(root))._write(mod.PacketGopSegment("cam", 0, None))
        assert not root.exists()


# -- the REST surface ------------------------------------------------------------------


class _PM:
    def list(self):
        return []


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


class TestCascadeEndpointConvention:
    def test_disabled_cascade_answers_400_envelope(self):
        """The JAX test serves tiny_mobilenet_v2, which the port's registry
        lacks; tiny_yolov8 stands in (the route reads ``engine.cascade``
        only)."""
        pytest.importorskip("aiohttp")
        from video_edge_ai_proxy_tpu_torch.serve.rest_api import RestServer

        bus = MemoryFrameBus()
        eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2),
                                                tick_ms=5), device="cpu")
        assert eng.cascade is None
        srv = RestServer(_PM(), None, host="127.0.0.1", port=0, engine=eng)
        srv.start()
        try:
            code, body = _get(f"http://127.0.0.1:{srv.bound_port}", "/api/v1/cascade")
            assert code == 400 and set(body) == {"code", "message"}
            assert "engine.cascade" in body["message"]
        finally:
            srv.stop()
            bus.close()

    def test_enabled_cascade_serves_snapshot(self):
        """With the cascade on both servers answer the same keys and
        values (a fresh engine: no tick yet)."""
        pytest.importorskip("aiohttp")
        from video_edge_ai_proxy_tpu.serve.rest_api import RestServer as JRestServer
        from video_edge_ai_proxy_tpu_torch.serve.rest_api import RestServer

        eng = _Engines()
        servers = [RestServer(_PM(), None, host="127.0.0.1", port=0, engine=eng.eng),
                   JRestServer(_PM(), None, host="127.0.0.1", port=0, engine=eng.jeng)]
        for srv in servers:
            srv.start()
        try:
            bodies = [_get(f"http://127.0.0.1:{srv.bound_port}", "/api/v1/cascade")
                      for srv in servers]
            assert bodies[0][0] == bodies[1][0] == 200
            assert bodies[0][1] == bodies[1][1]
            body = bodies[0][1]
            assert body["model"] == "tiny_videomae" and body["every_n"] == 2
            assert body["ticks"] == 0
            stats = _get(f"http://127.0.0.1:{servers[0].bound_port}", "/api/v1/stats")[1]
            assert stats["obs"]["cascade"] == body
        finally:
            for srv in servers:
                srv.stop()
            eng.close()

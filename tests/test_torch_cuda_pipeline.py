"""The serving pipeline's stream ordering on the card.

- A placement's copy is ordered before the step that reads it, and a
  pinned slot refilled two submissions later never reaches an earlier
  placement: every step reads its own frames.
- ``record_stream``: the memory of a placed tensor whose step is still
  running is not handed to the next placement.
- Frames outside pinned memory are refused (no synchronous copy), and
  batches whose transfer fails are dropped with a log line while the
  engine goes on serving; ``stop()`` does not raise.
- The pipelined engine folds the same result checksum as the synchronous
  path on ``tiny_yolov8``, and an engine over the shm bus folds the same
  checksum as over the memory bus.
- A failed CUDA-graph capture of one key is confined to it: another key
  still captures (into a fresh graph pool) and serves, and the failed
  key's batches raise without running eagerly.

Marked ``cuda``: each test skips without a GPU (decided inside a fixture).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_pipeline.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import logging
import shutil
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.bus.shm_bus import ShmFrameBus
from video_edge_ai_proxy_tpu_torch.engine import runner
from video_edge_ai_proxy_tpu_torch.engine.collector import BatchGroup
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, _pinned_empty
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda

SHAPE = (4, 256, 256, 3)
SLEEP_CYCLES = 20_000_000     # ~10 ms of a spinning kernel on the compute stream


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


def _engine(card, **cfg):
    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", **cfg),
                             device=card)
    engine.warmup()
    return engine


def _group(frames):
    return BatchGroup(frames.shape[1:3], ["cam"] * frames.shape[0], frames, [], frames.shape[0])


def test_slot_reuse_two_submissions_later_keeps_each_placement(card):
    engine = _engine(card)
    engine._xfer.start()
    slots = [_pinned_empty(SHAPE), _pinned_empty(SHAPE)]
    handles = []
    n = 8

    def produce():
        for i in range(n):
            if i >= 2:                      # the slot's last copy must be done
                handles[i - 2].ready.wait(30)
            slots[i % 2].fill(i + 1)
            handles.append(engine._xfer.submit(_group(slots[i % 2]), engine._stop))

    producer = threading.Thread(target=produce)
    producer.start()
    means = []
    try:
        with engine._compute_stream():
            stream = torch.cuda.current_stream()
            for i in range(n):
                while len(handles) <= i:
                    time.sleep(0.001)
                pre = handles[i]
                assert pre.ready.wait(30) and pre.error is None
                stream.wait_event(pre.event)
                pre.placed.record_stream(stream)
                torch.cuda._sleep(SLEEP_CYCLES)     # the step is still reading
                means.append(pre.placed.float().mean())
                pre.placed = None
        torch.cuda.synchronize()
    finally:
        producer.join(30)
        engine._xfer.stop()
    assert not producer.is_alive()
    assert [float(m) for m in means] == [float(i + 1) for i in range(n)]


def test_placed_memory_is_kept_while_its_step_runs(card):
    engine = _engine(card, quality_thumb=0)
    host = _pinned_empty(SHAPE)
    host.fill(3)

    def step(x):
        torch.cuda._sleep(SLEEP_CYCLES * 5)
        return {"mean": x.float().mean()}

    with engine._compute_stream():
        placed, event, ms = engine._xfer.place(host)
        ptr = placed.data_ptr()
        inflight = engine._run_step(step, _group(host), placed, event, time.time())
        del placed
        host.fill(5)
        again, event2, _ = engine._xfer.place(host)
        # Without record_stream the block would be free on the transfer
        # stream at once, and the new copy would overwrite the running
        # step's input.
        assert again.data_ptr() != ptr
        torch.cuda.synchronize()
    assert float(inflight.outputs["mean"]) == 3.0
    assert float(again.float().mean()) == 5.0 and ms >= 0.0


def test_pageable_frames_are_refused(card):
    engine = _engine(card)
    with pytest.raises(RuntimeError, match="pinned"):
        engine._xfer.place(np.zeros(SHAPE, np.uint8))


def test_transfer_error_ends_the_engine_and_stop_raises(card, caplog):
    """Log and continue: the batches whose transfer fails are dropped with
    "engine tick failed; continuing", the engine serves once the transfer
    works again, and stop() does not raise."""
    bus = MemoryFrameBus()
    bus.create_stream("cam0", 96 * 128 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5), device=card)
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
        deadline = time.monotonic() + 60
        while not got:
            assert time.monotonic() < deadline, "the engine did not serve after the failures"
            bus.publish("cam0", np.zeros((96, 128, 3), np.uint8), FrameMeta(packet=1))
            time.sleep(0.02)
        health = engine.health()
    finally:
        engine.stop()
    reader.join(10)
    assert failures["n"] == 3 and health["ok"], health
    logged = [r for r in caplog.records if r.getMessage() == "engine tick failed; continuing"]
    assert len(logged) == 3 and all(isinstance(r.exc_info[1], OSError) for r in logged)


def _fold(card, prefetch, bus=None):
    engine = InferenceEngine(bus or MemoryFrameBus(),
                             EngineConfig(model="tiny_yolov8", prefetch=prefetch,
                                          dtype="float32"), device=card)
    engine.warmup()
    engine._model.load_state_dict(zero_class_prior(engine._model.state_dict()))
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (5, 3, 96, 128, 3), dtype=np.uint8)
    fold = engine.serve_lockstep(
        [(f"cam{s}", frames[t, s], FrameMeta(packet=t)) for s in range(3)]
        for t in range(frames.shape[0]))
    return fold, engine.pipeline_stats().frames


def test_pipelined_engine_folds_like_the_synchronous_path(card):
    piped = _fold(card, True)
    sync = _fold(card, False)
    assert piped == sync and piped[0] > 0 and piped[1] == 15


def test_engine_over_the_shm_bus_folds_like_the_memory_bus(card):
    ring_dir = tempfile.mkdtemp(prefix="vep_rings_")
    bus = ShmFrameBus(ring_dir)
    try:
        shm = _fold(card, True, bus)
    finally:
        bus.close()
        shutil.rmtree(ring_dir, ignore_errors=True)
    assert shm == _fold(card, True) and shm[0] > 0 and shm[1] == 15


def test_a_failed_capture_leaves_other_keys_capturing(card, monkeypatch):
    build = runner.build_serving_step

    def breaking(model, spec, **kw):
        step = build(model, spec, **kw)

        def run(frames, *rest):
            out = step(frames, *rest)
            if tuple(frames.shape[1:3]) == (96, 128):
                out["boxes"].sum().item()   # a synchronising read: refused in a capture
            return out
        return run

    monkeypatch.setattr(runner, "build_serving_step", breaking)
    engine = _engine(card)
    with pytest.raises(Exception):
        engine.compile_for((96, 128), 1)
    assert engine.graph_stats()["programs"] == 0
    # The failed key raises at once, without a capture or an eager run.
    with pytest.raises(RuntimeError, match="failed to capture"):
        engine.compile_for((96, 128), 1)
    engine.compile_for((64, 80), 2)
    stats = engine.graph_stats()
    assert stats["programs"] == 1 and stats["pools"] == 2
    frames = torch.randint(0, 256, (2, 64, 80, 3), dtype=torch.uint8, device=card)
    with engine._compute_stream(), torch.inference_mode():
        out = engine._step((64, 80), 2)(frames, torch.zeros((2, 32, 32), device=card))
        eager = build(engine._model, engine._spec, quality_thumb=32)(
            frames, torch.zeros((2, 32, 32), device=card))
    torch.cuda.synchronize()
    for k in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(out[k], eager[k]), k


def test_a_key_that_keeps_failing_gives_up_one_pool_and_starves_no_other_key(card, monkeypatch,
                                                                              caplog):
    """Both geometries are dispatched in every tick; the one that sorts first
    fails to capture. It is never captured again (one pool given up, the
    pools' bytes flat), and the other key is served every tick."""
    build = runner.build_serving_step
    eager_calls = {"n": 0}

    def breaking(model, spec, **kw):
        step = build(model, spec, **kw)

        def run(frames, *rest):
            out = step(frames, *rest)
            if tuple(frames.shape[1:3]) == (64, 80):
                eager_calls["n"] += not torch.cuda.is_current_stream_capturing()
                out["boxes"].sum().item()   # a synchronising read: refused in a capture
            return out
        return run

    monkeypatch.setattr(runner, "build_serving_step", breaking)
    bus = MemoryFrameBus()
    bus.create_stream("fail", 64 * 80 * 3)
    bus.create_stream("ok", 96 * 128 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8"), device=card)
    results = engine.subscribe(["fail", "ok"], timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    caplog.set_level(logging.ERROR, logger=runner.log.name)
    engine._start_pipeline()
    rng = np.random.default_rng(0)
    stats = []
    try:
        with engine._compute_stream(), torch.inference_mode():
            for _ in range(6):
                for device_id, hw in (("fail", (64, 80)), ("ok", (96, 128))):
                    bus.publish(device_id, rng.integers(0, 256, hw + (3,), dtype=np.uint8),
                                FrameMeta(width=hw[1], height=hw[0]))
                groups = engine._collector.collect(device_ids=["fail", "ok"])
                assert [g.device_ids for g in groups] == [["fail"], ["ok"]]
                engine._dispatch(groups)
                torch.cuda.synchronize()
                stats.append(engine.graph_stats())
        engine._drain_q.join()
    finally:
        engine.stop()
    reader.join(10)
    assert [r.device_id for r in got] == ["ok"] * 6
    logged = [r for r in caplog.records if r.getMessage() == "engine tick failed; continuing"]
    assert len(logged) == 6
    # The failed key ran only its eager warmup calls before the capture.
    assert eager_calls["n"] == runner._GraphedStep.WARMUP_CALLS
    assert all(s["programs"] == 1 and s["pools"] == 2 for s in stats), stats
    assert len({s["pool_bytes"] for s in stats[1:]}) == 1, stats

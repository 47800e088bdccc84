"""The serving pipeline's stream ordering on the card.

- A placement's copy is ordered before the step that reads it, and a
  pinned slot refilled two submissions later never reaches an earlier
  placement: every step reads its own frames.
- ``record_stream``: the memory of a placed tensor whose step is still
  running is not handed to the next placement.
- Frames outside pinned memory are refused (no synchronous copy), and an
  error on the transfer thread ends the engine and is raised by ``stop()``.
- The pipelined engine folds the same result checksum as the synchronous
  path on ``tiny_yolov8``.

Marked ``cuda``: each test skips without a GPU (decided inside a fixture).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_pipeline.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import threading
import time

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
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


def test_transfer_error_ends_the_engine_and_stop_raises(card):
    bus = MemoryFrameBus()
    bus.create_stream("cam0", 96 * 128 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5), device=card)

    def broken(frames):
        raise OSError("transfer failed")

    engine._xfer.place = broken
    engine.start()
    deadline = time.monotonic() + 60
    while not engine._stop.is_set():
        assert time.monotonic() < deadline, "the engine did not end"
        bus.publish("cam0", np.zeros((96, 128, 3), np.uint8), FrameMeta(packet=1))
        time.sleep(0.02)
    with pytest.raises(RuntimeError, match="engine failed") as info:
        engine.stop()
    assert isinstance(info.value.__cause__, OSError)


def _fold(card, prefetch):
    bus = MemoryFrameBus()
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", prefetch=prefetch,
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

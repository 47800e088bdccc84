"""The port's engine logs a failure and goes on serving, as the JAX engine
does ("engine tick failed; continuing", "drain failed; continuing").

- The reference's ``test_engine_survives_tick_exceptions``, with its
  injection (collect raises three times, then results flow), on the port's
  engine on the CPU.
- A batch whose emit fails is logged, its lease returned, and the next
  batch is emitted.
- A batch whose step fails is dropped (never run another way), its lease
  returned, and the engine serves the next one, the batches after it in
  the same tick included.
- Only a thread that cannot run at all ends the engine, and ``stop()``
  raises it.
"""

import logging
import threading
import time

import numpy as np
import pytest

from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import runner
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


def _publish(bus, device_id, w=64, h=64, value=128):
    bus.publish(device_id, np.full((h, w, 3), value, np.uint8),
                FrameMeta(width=w, height=h, timestamp_ms=int(time.time() * 1000)))


def _engine(bus, **cfg):
    return InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5, **cfg),
                           device="cpu")


def _logged(caplog, message):
    return [r for r in caplog.records if r.getMessage() == message]


def test_engine_survives_tick_exceptions(caplog):
    bus = MemoryFrameBus()
    bus.create_stream("cam1", 64 * 64 * 3)
    eng = _engine(bus)
    orig_collect = eng._collector.collect
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise RuntimeError("injected tick failure")
        return orig_collect(*args, **kwargs)

    eng._collector.collect = flaky
    caplog.set_level(logging.ERROR, logger=runner.log.name)
    eng.start()
    try:
        sub = eng.subscribe(timeout=0.1)
        results = []
        deadline = time.time() + 30
        while not results and time.time() < deadline:
            _publish(bus, "cam1")
            try:
                results.append(next(sub))
            except StopIteration:
                break
        health = eng.health()
    finally:
        eng.stop()
    assert calls["n"] > 3, "injected failures never triggered"
    assert results, "engine did not recover from injected tick failures"
    assert health["ok"] and health["engine_thread_alive"], health
    assert len(_logged(caplog, "engine tick failed; continuing")) == 3


def _serve_until(engine, bus, until, deadline_s=30):
    engine.start()
    deadline = time.monotonic() + deadline_s
    while not until():
        assert time.monotonic() < deadline, "timed out"
        _publish(bus, "cam0")
        time.sleep(0.02)


def test_a_failed_emit_is_logged_and_the_next_batch_emitted(caplog):
    bus = MemoryFrameBus()
    bus.create_stream("cam0", 64 * 64 * 3)
    engine = _engine(bus)
    emit = engine._emit
    failed = []

    def flaky(inflight):
        if not failed:
            failed.append(inflight.group)
            raise ValueError("injected drain failure")
        return emit(inflight)

    engine._emit = flaky
    results = engine.subscribe(timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    caplog.set_level(logging.ERROR, logger=runner.log.name)
    try:
        _serve_until(engine, bus, lambda: len(got) >= 3)
        health = engine.health()
    finally:
        engine.stop()          # does not raise
    reader.join(10)
    (record,) = _logged(caplog, "drain failed; continuing")
    assert isinstance(record.exc_info[1], ValueError)
    assert failed[0].lease is None       # its pooled buffer went back
    assert health["ok"] and health["drain_thread_alive"], health
    assert engine.pipeline_stats().batches >= len(got) + 1


def test_a_failed_step_drops_its_batch_and_returns_its_lease(caplog):
    bus = MemoryFrameBus()
    bus.create_stream("cam0", 64 * 64 * 3)
    engine = _engine(bus, prefetch=False)
    engine.warmup()
    step_of = engine._step
    calls = {"n": 0}

    def flaky_step(src_hw, bucket, model=None):
        step = step_of(src_hw, bucket, model)

        def run(*args):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("injected step failure")
            return step(*args)
        return run

    engine._step = flaky_step
    results = engine.subscribe(timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    caplog.set_level(logging.ERROR, logger=runner.log.name)
    try:
        _serve_until(engine, bus, lambda: len(got) >= 2)
    finally:
        engine.stop()
    reader.join(10)
    assert len(_logged(caplog, "engine tick failed; continuing")) == 2
    # Two batches dropped: the results counted are the batches that ran.
    assert engine.pipeline_stats().batches == calls["n"] - 2 >= 2
    assert all(not slot["leased"] for slot in engine._collector._pool.values())


@pytest.mark.parametrize("prefetch", [False, True])
def test_a_failing_key_does_not_starve_the_keys_after_it(caplog, prefetch):
    """Both geometries are published in every tick; the one that sorts first
    fails at every step, and the other is served each tick all the same."""
    bus = MemoryFrameBus()
    bus.create_stream("fail", 48 * 64 * 3)
    bus.create_stream("ok", 64 * 64 * 3)
    engine = _engine(bus, prefetch=prefetch)
    step_of = engine._step

    def failing_step(src_hw, bucket, model=None):
        step = step_of(src_hw, bucket, model)
        if tuple(src_hw) != (48, 64):
            return step

        def run(*args):
            raise RuntimeError("injected step failure")
        return run

    engine._step = failing_step
    results = engine.subscribe(["fail", "ok"], timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    caplog.set_level(logging.ERROR, logger=runner.log.name)
    engine._start_pipeline()
    try:
        for _ in range(3):
            _publish(bus, "fail", h=48)
            _publish(bus, "ok")
            groups = engine._collector.collect(device_ids=["fail", "ok"])
            assert [g.device_ids for g in groups] == [["fail"], ["ok"]]
            engine._dispatch(groups)
        engine._drain_q.join()
    finally:
        engine.stop()
    reader.join(10)
    assert [r.device_id for r in got] == ["ok"] * 3
    logged = _logged(caplog, "engine tick failed; continuing")
    assert len(logged) == 3 and all(isinstance(r.exc_info[1], RuntimeError) for r in logged)
    assert engine.pipeline_stats().batches == 3
    assert all(not slot["leased"] for slot in engine._collector._pool.values())


def test_a_thread_that_cannot_run_ends_the_engine_and_stop_raises(monkeypatch):
    bus = MemoryFrameBus()
    engine = _engine(bus)

    def cannot_run():
        raise SystemExit("the tick thread cannot run")

    monkeypatch.setattr(engine, "_serve_ticks", cannot_run)
    engine.start()
    deadline = time.monotonic() + 10
    while not engine._stop.is_set():
        assert time.monotonic() < deadline, "the engine did not end"
        time.sleep(0.01)
    assert not engine.health()["ok"]
    with pytest.raises(RuntimeError, match="engine failed") as info:
        engine.stop()
    assert isinstance(info.value.__cause__, SystemExit)

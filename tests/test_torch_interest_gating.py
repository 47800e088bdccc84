"""Interest gating of the port's collector and engine, held against the JAX
package's collector.

- The reference's ``test_keep_streams_hot_touches_query`` (its
  ``interest_of`` form) and ``test_interest_gating_with_linger`` on the
  port's collector.
- One sequence of interest changes on a shared fake clock through both
  collectors: ``partition()``, ``keep_streams_hot`` and the ``last_query``
  stamps they leave agree at every step.
- The port's engine infers a subscribed stream and gates an unsubscribed
  one (no results, no keep-hot); a subscription whose context ends takes
  its interest with it; an engine with no subscriber infers nothing.
"""

import threading
import time
import types

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import collector
from video_edge_ai_proxy_tpu_torch.engine.collector import Collector
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


def _publish(bus, device_id, meta_t=FrameMeta, w=64, h=64, value=128):
    bus.publish(device_id, np.full((h, w, 3), value, np.uint8),
                meta_t(width=w, height=h, timestamp_ms=int(time.time() * 1000)))


def test_keep_streams_hot_touches_query():
    bus = MemoryFrameBus()
    bus.create_stream("cam1", 16)
    col = Collector(bus, interest_of=lambda d: True)
    assert bus.last_query_ms("cam1") is None
    assert col.keep_streams_hot(now_ms=12345) == ["cam1"]
    assert bus.last_query_ms("cam1") == 12345
    # No interest_of: nothing is gated, every stream is kept hot.
    assert Collector(bus).keep_streams_hot(now_ms=777) == ["cam1"]
    assert bus.last_query_ms("cam1") == 777


def test_interest_gating_with_linger():
    """No consumer -> after the active_window_s linger the stream drops out
    of the batch; interest returning re-admits it at once."""
    bus = MemoryFrameBus()
    bus.create_stream("cam1", 64 * 64 * 3)
    interested = {"on": True}
    col = Collector(bus, buckets=(1,), active_window_s=0.2,
                    interest_of=lambda d: interested["on"])
    _publish(bus, "cam1")
    assert col.inference_streams() == ["cam1"]
    assert col.collect()
    interested["on"] = False
    assert col.inference_streams() == ["cam1"]    # within the linger
    time.sleep(0.25)
    assert col.inference_streams() == []          # the linger ran out
    assert col.keep_streams_hot() == []
    _publish(bus, "cam1")
    assert col.collect() == []                    # gated: no batches
    interested["on"] = True
    assert col.inference_streams() == ["cam1"]    # re-admitted at once
    assert col.collect()


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


# (seconds the clock moves first, streams with interest) per step, with
# active_window_s = 2: a stream with interest from the start, one whose
# interest comes late, lapses and comes back within and past the linger,
# one that never has any, and one that appears mid-way.
STEPS = [
    (0.0, {"a"}), (0.5, {"a", "b"}), (1.0, {"a"}), (1.5, {"a"}), (0.49, {"a"}),
    (0.02, {"a"}), (0.0, {"a", "b"}), (3.0, set()), (1.99, set()), (0.01, set()),
    (0.5, {"b", "d"}), (0.0, {"d"}), (2.5, {"d"}), (10.0, {"a", "b", "c", "d"}),
]


def test_partition_and_keep_hot_agree_with_jax(monkeypatch):
    clock = _Clock()
    fake_time = types.SimpleNamespace(monotonic=clock.monotonic, time=time.time,
                                      sleep=time.sleep)
    monkeypatch.setattr(collector, "time", fake_time)
    monkeypatch.setattr(jcollector, "time", fake_time)
    interested: set = set()
    bus, jbus = MemoryFrameBus(), JMemoryFrameBus()
    col = Collector(bus, active_window_s=2.0, interest_of=lambda d: d in interested)
    jcol = jcollector.Collector(jbus, active_window_s=2.0,
                                interest_of=lambda d: d in interested)
    for b in (bus, jbus):
        for d in ("a", "b", "c"):
            b.create_stream(d, 64)
    lingered = gated_again = 0
    col_prev: list = []
    for i, (dt, who) in enumerate(STEPS):
        clock.t += dt
        interested.clear()
        interested.update(who)
        if i == 10:
            bus.create_stream("d", 64)
            jbus.create_stream("d", 64)
        got = col.partition()
        want = jcol.partition()
        assert got == want, f"step {i}: {got} != {want}"
        lingered += sum(1 for d in got[1] if d not in who)
        gated_again += i > 0 and "b" in col_prev and "b" not in got[1]
        col_prev = got[1]
        now_ms = 5000 + i
        assert col.keep_streams_hot(now_ms=now_ms, device_ids=got[1]) == \
            jcol.keep_streams_hot(now_ms=now_ms, device_ids=want[1])
        assert col.inference_streams() == jcol.inference_streams()
        stamps = {d: bus.last_query_ms(d) for d in bus.streams()}
        assert stamps == {d: jbus.last_query_ms(d) for d in jbus.streams()}
    # The sequence ran through the linger and out of it.
    assert lingered == 2 and gated_again >= 1


def _serve(engine, bus, streams, until, deadline_s=60):
    """Publish a frame on every stream each 20 ms until ``until()``."""
    engine.start()
    try:
        deadline = time.monotonic() + deadline_s
        while not until():
            assert time.monotonic() < deadline, "timed out"
            for s in streams:
                _publish(bus, s)
            time.sleep(0.02)
    finally:
        engine.stop()


def test_engine_serves_the_subscribed_stream_and_gates_the_other():
    bus = MemoryFrameBus()
    for s in ("cam0", "cam1"):
        bus.create_stream(s, 64 * 64 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5), device="cpu")
    results = engine.subscribe(["cam0"], timeout=0.1)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    _serve(engine, bus, ["cam0", "cam1"], lambda: len(got) >= 5)
    reader.join(10)
    assert {r.device_id for r in got} == {"cam0"}
    stats = engine.stats()
    assert stats["cam0"].frames >= 5 and "cam1" not in stats
    assert bus.last_query_ms("cam0") is not None
    assert bus.last_query_ms("cam1") is None      # its worker's gate stays closed
    # The subscriber is gone; cam0 lingers for active_window_s (10 s).
    assert not engine._subscribers
    assert engine._collector.partition() == (["cam0", "cam1"], ["cam0"])


class _Context:
    def __init__(self):
        self.active = True

    def is_active(self):
        return self.active


def test_a_subscription_whose_context_ends_takes_its_interest_with_it():
    bus = MemoryFrameBus()
    bus.create_stream("cam0", 64 * 64 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5,
                                               active_window_s=0.0), device="cpu")
    ctx = _Context()
    results = engine.subscribe(["cam0"], context=ctx, timeout=0.05)
    got = []
    reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
    reader.start()
    engine.start()
    try:
        deadline = time.monotonic() + 60
        while not got:
            assert time.monotonic() < deadline, "not served"
            _publish(bus, "cam0")
            time.sleep(0.02)
        ctx.active = False
        reader.join(10)
        assert not reader.is_alive(), "the subscription did not end with its context"
        assert engine._collector.inference_streams() == []
        time.sleep(0.3)        # what was dispatched before is emitted
        frames = engine.stats()["cam0"].frames
        for _ in range(10):
            _publish(bus, "cam0")
            time.sleep(0.02)
        time.sleep(0.2)
        assert engine.stats()["cam0"].frames == frames   # gated: nothing more inferred
    finally:
        engine.stop()


def test_an_engine_with_no_subscriber_infers_nothing():
    bus = MemoryFrameBus()
    bus.create_stream("cam1", 64 * 64 * 3)
    engine = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", active_window_s=0.0),
                             device="cpu")
    _publish(bus, "cam1")
    assert engine._collector.inference_streams() == []
    assert engine._collector.collect() == []
    assert engine._collector.keep_streams_hot() == []
    assert bus.last_query_ms("cam1") is None


@pytest.mark.parametrize("prefetch", [True, False])
def test_replay_stays_ungated(prefetch):
    """serve_lockstep infers every published stream with no subscriber, as
    the JAX lockstep harness builds its collector without interest."""
    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8",
                                                            prefetch=prefetch), device="cpu")
    engine.warmup()
    engine._model.load_state_dict(zero_class_prior(engine._model.state_dict()))
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 3, 48, 64, 3), dtype=np.uint8)
    fold = engine.serve_lockstep([(f"cam{s}", frames[t, s], FrameMeta(packet=t))
                                  for s in range(3)] for t in range(2))
    assert fold != 0 and engine.pipeline_stats().frames == 6

"""The port's capacity attribution plane (``obs/capacity.py``) and its
engine taps against the JAX package's.

- The same ``note_batch``/``note_coast``/``evaluate`` sequence on a fake
  clock through both trackers gives equal snapshots (floats to 1e-9
  relative, the rest exact) and equal ``vep_capacity_*`` families.
- ``tools/torch_capacity_smoke.py``'s parts on the CPU: part A (a
  hand-stepped engine with ROI, the cascade and the full path live) passes
  JAX's gates; parts B and C equal ``tools/capacity_smoke.py``'s.
- The engine with ``capacity=False`` has no tracker and no tap; the
  engine's device time on the CPU includes the step (JAX's submit ->
  drained), so the capacity plane reads a step's cost there.
"""

import importlib.util
import math
import os
import queue
import time

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.obs import capacity as jcapacity
from video_edge_ai_proxy_tpu.obs.metrics import Registry as JRegistry
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.obs import capacity
from video_edge_ai_proxy_tpu_torch.obs.metrics import Registry, lint_exposition
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-9


def close(a, b, path="$"):
    """Equal, floats to REL relative (1e-12 absolute near zero)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _drive(mod, registry, script, **kw):
    clock = FakeClock()
    cap = mod.CapacityTracker(clock=clock, registry=registry, eval_interval_s=0.0,
                              fast_window_s=10.0, slow_window_s=100.0, **kw)
    states = []
    for step in script:
        op = step[0]
        if op == "advance":
            clock.now += step[1]
        elif op == "batch":
            _, args, kwargs = step
            cap.note_batch(*args, **kwargs)
        elif op == "coast":
            cap.note_coast(step[1])
        elif op == "eval":
            states.append(cap.evaluate(force=True))
    states.append(cap.snapshot())
    return states


SCRIPTS = {
    "mixed_kinds": [
        ("batch", ("yolov8n", (1080, 1920), 4, 9.5, ["a", "b", "c"]), {}),
        ("advance", 0.5),
        ("batch", ("yolov8n", (640, 640), 2, 4.3, ["d", "e"]),
         {"weights": [3000, 1000], "kind": "roi"}),
        ("coast", ["f", "g"]),
        ("batch", ("cascade/videomae_b", (224, 224), 2, 7.1, ["a", "d"]),
         {"kind": "cascade", "amortize_n": 4}),
        ("eval",),
        ("advance", 1.0),
        ("batch", ("yolov8n", (1080, 1920), 4, 9.7, ["a", "b", "c"]), {}),
        ("batch", ("yolov8n", (1080, 1920), 1, 3.3, []), {}),
        ("eval",),
    ],
    "ramp_and_expiry": (
        [step for t in range(1, 40) for step in (
            ("advance", 1.0),
            ("batch", ("ramp", (64, 64), 4, 5.0 * t, [f"s{t % 3}"]), {}),
            ("eval",))]
        + [("advance", 150.0), ("eval",),
           ("batch", ("ramp", (64, 64), 4, 0.1, ["late"]), {"weights": [0.0]}), ("eval",)]),
    "zero_weights_and_shards": [
        ("batch", ("m", (32, 32), 8, 2.0, ["x", "y"]), {"weights": [0, 0]}),
        ("batch", ("m", (32, 32), 8, 3.0, ["x", "y"]),
         {"shard_streams": {"0": ["x"], "1": ["y"]}}),
        ("advance", 2.0), ("eval",),
    ],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_tracker_sequence_equals_jax(script):
    port_reg, jax_reg = Registry(), JRegistry()
    port = _drive(capacity, port_reg, SCRIPTS[script])
    jax_ = _drive(jcapacity, jax_reg, SCRIPTS[script])
    close(port, jax_)
    assert port_reg.render() == jax_reg.render()
    assert not lint_exposition(port_reg.render())


def test_tracker_families_and_constants_equal_jax():
    port_reg, jax_reg = Registry(), JRegistry()
    capacity.CapacityTracker(registry=port_reg)
    jcapacity.CapacityTracker(registry=jax_reg)
    names = sorted(f.name for f in port_reg.families())
    assert names == sorted(f.name for f in jax_reg.families())
    assert all(n.startswith("vep_capacity_") for n in names) and len(names) == 10
    assert port_reg.render() == jax_reg.render()
    assert (capacity.OVERHEAD_STREAM, capacity.CONSERVATION_REL_TOL) == (
        jcapacity.OVERHEAD_STREAM, jcapacity.CONSERVATION_REL_TOL)
    for kw in ({"util_objective": 0.0}, {"fast_window_s": 100.0, "slow_window_s": 10.0}):
        for mod in (capacity, jcapacity):
            with pytest.raises(ValueError):
                mod.CapacityTracker(registry=Registry(), **kw)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_capacity_smoke_parts_pass_jax_gates_on_the_cpu():
    tool = _tool("torch_capacity_smoke")
    a = tool.part_a("cpu", (64, 64))
    b, c = tool.part_b(), tool.part_c()
    # Every gate but the tap's wall time, a host timing that a loaded test
    # machine can push past 1% of the tick: chip_smoke.py phase 22a holds it.
    assert [f for f in tool.capacity_failures(a, b, c)
            if not f.startswith("ledger tap costs")] == []
    assert a["ledger_taps"] > 0 and a["ledger_tap_mean_us"] > 0.0
    assert a["kinds"] == ["cascade", "full", "roi"] and a["conservation"]["rel_drift"] == 0.0
    assert sorted(a["by_stream"]["camA"]) == ["cascade", "full"]
    jtool = _tool("capacity_smoke")
    close(b, jtool._part_b())
    close(c, jtool._part_c())


def _engine(**kw):
    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2, 4),
                                            prefetch=False, track=False, **kw), device="cpu")
    eng._model = eng._spec.init_params(torch.Generator().manual_seed(0), device="cpu",
                                       dtype=torch.float32)
    eng.warmup()
    eng._drain_q = queue.Queue(maxsize=8)
    with eng._sub_lock:            # one subscriber over every stream: all inferred
        eng._subscribers.append((queue.Queue(), None))
    return bus, eng


def _tick(bus, eng, names):
    ts = int(time.time() * 1000)
    for n in names:
        bus.publish(n, np.full((32, 32, 3), 90, np.uint8),
                    FrameMeta(width=32, height=32, channels=3, timestamp_ms=ts))
    with torch.inference_mode():
        eng._dispatch(eng._collector.collect(), time.time())
    while True:
        try:
            inflight = eng._drain_q.get_nowait()
        except queue.Empty:
            break
        try:
            eng._emit(inflight)
        finally:
            eng._collector.release(inflight.group)
            eng._drain_q.task_done()


def test_capacity_off_leaves_no_tracker():
    bus, eng = _engine()
    try:
        assert eng.capacity is None
        bus.create_stream("cam0", 32 * 32 * 3)
        _tick(bus, eng, ["cam0"])
        assert eng.capacity is None and eng.pipeline_stats().batches == 1
    finally:
        bus.close()


def test_the_full_path_taps_the_ledger_by_slot():
    bus, eng = _engine(capacity=True, capacity_fast_window_s=5.0)
    try:
        names = ["cam0", "cam1", "cam2"]
        for n in names:
            bus.create_stream(n, 32 * 32 * 3)
        for _ in range(3):
            _tick(bus, eng, names)
        snap = eng.capacity.snapshot()
        cons = snap["conservation"]
        assert cons["balanced"] and cons["measured_ms"] > 0.0
        assert sorted(snap["streams"]) == names
        assert {r["batches"] for r in snap["streams"].values()} == {3}
        # One bucket-4 batch a tick, its cost split equally by slot.
        assert list(snap["cells"]) == ["tiny_yolov8|32x32|4"]
        shares = [r["by_kind"]["full"] for r in snap["streams"].values()]
        assert max(shares) - min(shares) <= 1e-9 * max(shares)
    finally:
        bus.close()


def test_device_time_on_the_cpu_includes_the_step():
    """The repair: on the CPU the step runs inside the dispatch call, and
    ``t_submit`` was taken after it, so the engine's device time (and the
    capacity plane's measured ms, and ``vep_device_batch_ms``) missed the
    step; JAX's CPU submit -> drained includes it."""
    bus, eng = _engine(capacity=True)
    try:
        real = eng._step

        def slow_step(*a, **k):
            fn = real(*a, **k)

            def run(*args):
                time.sleep(0.05)
                return fn(*args)
            return run

        eng._step = slow_step
        bus.create_stream("cam0", 32 * 32 * 3)
        _tick(bus, eng, ["cam0"])
        assert eng.capacity.conservation()["measured_ms"] >= 50.0
    finally:
        bus.close()

"""The port's canary integrity loop against the JAX package's.

- ``CanaryChecker`` (``obs/quality.py``) on both packages over one note
  sequence (``tests/test_quality.py:179``): adoption, one watchdog
  episode per mismatch run, dropped and duplicated frames voiding a
  cycle, the SLO samples, the snapshots and the exposition.
- The engine's loop on the CPU (``engine/runner.py`` ``_start_canary``):
  a golden trace replayed into the bus by the engine's own publisher,
  served through the whole path with no subscriber (the canary stream is
  of interest on its own), each slot's host checksum noted; the same
  notes through the JAX checker give the same snapshot. The integrity
  SLO joins the engine's SLOs, the quality snapshot carries the canary,
  and ``admission_pause`` never pauses the canary.
"""

import time

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs import quality as jquality
from video_edge_ai_proxy_tpu.obs import watch as jwatch
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.obs import metrics, quality, watch
from video_edge_ai_proxy_tpu_torch.replay import recorder
from video_edge_ai_proxy_tpu_torch.resilience.ladder import RUNGS
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

PACKAGES = {"jax": (jquality, jwatch, jmetrics), "port": (quality, watch, metrics)}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class SLO:
    def __init__(self):
        self.good = self.bad = 0.0

    def record(self, good=0.0, bad=0.0):
        self.good += good
        self.bad += bad


def run_notes(qmod, wmod, mmod, notes, loop_len=4, golden=None):
    """Feed ``notes`` ((packet, checksum) pairs, or "snap" to take the
    watchdog's episodes) to a checker; its snapshots, SLO samples,
    episodes and exposition."""
    reg = mmod.Registry()
    wd = wmod.Watchdog()
    slo = SLO()
    c = qmod.CanaryChecker(loop_len=loop_len, golden=golden, registry=reg, watchdog=wd,
                           slo=slo, clock=Clock())
    trail = []
    for note in notes:
        if note == "snap":
            trail.append((c.snapshot(), dict(wd.snapshot()["episodes"]), sorted(wd.active())))
        else:
            c.note(*note)
    text = reg.render()
    return {"trail": trail, "final": c.snapshot(), "slo": (slo.good, slo.bad),
            "exposition": text, "lint": mmod.lint_exposition(text)}


def cycle(values):
    return [(p, v) for p, v in enumerate(values)]


GOOD = [11, 22, 33, 44]
BAD = [11, 22, 33, 999]
SEQUENCES = {
    "adopt_then_one_episode_per_mismatch_run": (
        cycle(GOOD) + cycle(GOOD) + ["snap"] + cycle(GOOD) + cycle(BAD) + cycle(BAD) + ["snap"]
        + cycle(BAD) + ["snap"] + cycle(GOOD) + cycle(GOOD) + ["snap"] + cycle(BAD)
        + cycle(BAD) + ["snap"], None),
    "a_dropped_frame_voids_the_cycle": ([(0, 11), (1, 22), (3, 44), (0, 11), "snap"], 123),
    "a_duplicate_voids_the_cycle": ([(0, 11), (1, 22), (1, 22), "snap"], 123),
    "a_committed_golden_mismatches": (cycle(GOOD) + cycle(GOOD) + ["snap"], 7),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_checker_equals_jax(name):
    notes, golden = SEQUENCES[name]
    got = {tag: run_notes(*mods, notes, golden=golden) for tag, mods in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["lint"] == []
    if name.startswith("adopt"):
        episodes = [t[1].get("canary_integrity", 0) for t in got["port"]["trail"]]
        assert episodes == [0, 1, 1, 1, 2]
        assert got["port"]["final"]["adopted"]


def test_loop_len_validated():
    for qmod, _, mmod in PACKAGES.values():
        with pytest.raises(ValueError):
            qmod.CanaryChecker(loop_len=0, registry=mmod.Registry())


@pytest.fixture()
def canary_trace(tmp_path):
    return recorder.record_synthetic_trace(str(tmp_path / "canary.vtrace"), ["golden"],
                                           width=64, height=48, frames=3)


def test_the_engine_loop_serves_the_canary_and_folds_like_jax(canary_trace):
    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2),
                                            tick_ms=5, quality_canary=canary_trace,
                                            quality_canary_fps=40.0), device="cpu")
    eng._model = eng._spec.init_params(torch.Generator().manual_seed(0), device="cpu",
                                       dtype=torch.float32)
    notes = []
    try:
        eng.start()
        assert eng.canary is not None and "canary_integrity" in eng.slo.snapshot()["slos"]
        note = eng.canary.note
        eng.canary.note = lambda p, c: (notes.append((p, c)), note(p, c))
        deadline = time.monotonic() + 60
        while eng.canary.match_cycles < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        snap = eng.canary.snapshot()
        quality_snap = eng.quality.snapshot()
    finally:
        eng.stop()
        bus.close()
    assert snap["match_cycles"] >= 2 and snap["adopted"] and snap["mismatch_cycles"] == 0
    assert snap["stream"] == "_canary" and snap["loop_len"] == 3
    assert "_canary" in quality_snap["streams"]
    port = quality.CanaryChecker(loop_len=3, registry=metrics.Registry())
    jax_ = jquality.CanaryChecker(loop_len=3, registry=jmetrics.Registry())
    for p, c in notes:
        port.note(p, c)
        jax_.note(p, c)
    assert port.snapshot() == jax_.snapshot()
    assert port.golden == snap["golden"]


def test_admission_pause_never_pauses_the_canary():
    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2, 4),
                                            prefetch=False), device="cpu")
    eng.canary = quality.CanaryChecker(loop_len=3, registry=metrics.Registry())
    sub = eng.subscribe()              # every stream of interest
    eng._model = eng._spec.init_params(torch.Generator().manual_seed(0), device="cpu",
                                       dtype=torch.float32)
    for name in ("0cam", "1cam", "2cam", "_canary"):
        bus.create_stream(name, 32 * 32 * 3)
        bus.publish(name, np.zeros((32, 32, 3), np.uint8),
                    FrameMeta(width=32, height=32, channels=3,
                              timestamp_ms=int(time.time() * 1000)))
    eng.ladder._rung = RUNGS.index("admission_pause")
    with torch.inference_mode():
        inferred = eng._tick(0.01)
    sub.close()
    assert eng.ladder.rung == "admission_pause"
    assert sorted(inferred) == ["0cam", "1cam", "_canary"]
    eng._drain_q.queue.clear()
    bus.close()

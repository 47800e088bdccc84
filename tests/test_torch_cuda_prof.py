"""The profiler plane on the card (``obs/prof.py``): a bounded
torch.profiler capture of an engine on the CUDA device.

- The keep-mask kernel run inside the engine's CUDA-graph replays is in
  the bundle's device trace, one event a replay, as many as its wrapper
  counted.
- A capture during which the card ran nothing records no CUDA activity:
  its manifest carries the error (no CPU-only bundle in its place), it is
  counted, and the next capture runs.
- A capture while another torch.profiler session runs is refused, and
  the busy flag stays clear.

Marked ``cuda``: each test skips without a GPU (decided inside a
fixture). Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_prof.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import json
import os
import time

import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda

HW, BUCKET = (96, 128), 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


@pytest.fixture()
def engine(card, tmp_path):
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", batch_buckets=(1, BUCKET), prof_dir=str(tmp_path / "ring")),
        device="cuda")
    eng.warmup()
    eng.compile_for(HW, BUCKET)           # captures the key's graph
    return eng


def _replays(eng, n):
    """A capture's 'sleep' that replays the key's graph ``n`` times."""
    def run(_seconds):
        frames = torch.zeros((BUCKET,) + HW + (3,), dtype=torch.uint8, device="cuda")
        thumbs = torch.zeros((BUCKET, 32, 32), dtype=torch.float32, device="cuda")
        with eng._compute_stream(), torch.inference_mode():
            step = eng._step(HW, BUCKET)
            for _ in range(n):
                step(frames, thumbs)
        torch.cuda.synchronize()
    return run


def _kernels(man):
    with open(os.path.join(man["path"], man["device_trace"])) as f:
        events = json.load(f)["traceEvents"]
    return [ev["name"] for ev in events if ev.get("cat") == "kernel"]


def test_a_capture_sees_the_keep_mask_inside_graph_replays(engine):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    engine.prof._sleep = _replays(engine, 5)
    before = nms_keep_mask_cuda.launches
    man = engine.prof.capture(100)
    assert man["error"] is None, man["error"]
    names = _kernels(man)
    nms = sum("nms_keep_mask_kernel" in n for n in names)
    print(f"{len(names)} kernel events, {nms} of the keep mask; "
          f"wall {man['wall_ms']} ms for a {man['ms']} ms capture")
    assert nms == 5 == nms_keep_mask_cuda.launches - before


def test_an_idle_card_is_an_error_not_a_cpu_bundle(engine):
    engine.prof._sleep = time.sleep
    torch.cuda.synchronize()
    man = engine.prof.capture(50)
    assert man["error"] == "RuntimeError: the capture recorded no CUDA activity"
    assert engine.prof.errors == 1
    engine.prof._sleep = _replays(engine, 1)
    assert engine.prof.capture(50)["error"] is None


def test_a_foreign_session_is_refused(engine):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        man = engine.prof.capture(50)
    assert "another torch.profiler session is active" in man["error"]
    assert engine.prof.snapshot()["busy"] is None
    engine.prof._sleep = _replays(engine, 1)
    assert engine.prof.capture(50)["error"] is None

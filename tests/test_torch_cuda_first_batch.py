"""A freshly started engine serves its first paced frames on the card.

A process's first served batch used to pay the first use of the serving
path: 0.5-0.9 s on one H100 with its program prewarmed, most of it the
first thumbnail gather on the tick thread. The tick loop stalled behind it,
and a paced stream had a frame overwritten in its latest-wins ring
before it was collected. ``InferenceEngine.start()`` now warms the
path on the tick thread before its first tick.

The engine runs in a process of its own (first uses are a process's):
``yolov8n`` at full width over 1920x1080 frames, its bucket prewarmed,
five streams published together every 0.2 s. Every packet of every
stream must be served, and the first batch must take less than the
frame period from collect to emitted. Without the warm-up the first
batch took 504-634 ms from collect to emitted on one H100 (the first
thumbnail gather on the tick thread: 477-605 ms of it).

Marked ``cuda``: skips without a GPU. Run on a machine with a card with

    python -m pytest tests/test_torch_cuda_first_batch.py -m cuda -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = 5
PACKETS = 10
PERIOD_S = 0.2

CHILD = r"""
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

streams, packets, period_s = int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])
H, W, BUCKET = 1080, 1920, 8
bus = MemoryFrameBus()
engine = InferenceEngine(bus, EngineConfig(
    model="yolov8n", track=False, batch_buckets=(BUCKET,), prewarm=[[H, W, BUCKET]],
    stage_trace=True), device="cuda")
engine.start()
served = {}
results = engine.subscribe()

def read():
    for res in results:
        served.setdefault(res.device_id, []).append(res.frame_packet)

reader = threading.Thread(target=read, daemon=True)
reader.start()
names = [f"cam{i}" for i in range(streams)]
for name in names:
    bus.create_stream(name, H * W * 3)
frame = np.full((H, W, 3), 114, np.uint8)
t0 = time.monotonic()
for k in range(1, packets + 1):
    time.sleep(max(0.0, t0 + (k - 1) * period_s - time.monotonic()))
    for name in names:
        bus.publish(name, frame, FrameMeta(width=W, height=H, channels=3, is_keyframe=True,
                                           timestamp_ms=int(time.time() * 1000), packet=k))
time.sleep(2.0)
engine.stop()
reader.join(5)
first = min(engine.stage_records, key=lambda r: r["t_collect"], default=None)
print(json.dumps({
    "served": served,
    "first_batch": None if first is None else {
        "collect_to_emitted_ms": (first["t_emitted"] - first["t_collect"]) * 1000.0,
        "submit_to_drained_ms": (first["t_drained"] - first["t_submit"]) * 1000.0},
}))
"""


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()


def run_child(code: str = CHILD) -> dict:
    """The paced run in a fresh process -> its JSON line."""
    proc = subprocess.run([sys.executable, "-c", code, ROOT, str(STREAMS), str(PACKETS),
                           str(PERIOD_S)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_fresh_engine_serves_its_first_paced_frames(card):
    out = run_child()
    want = list(range(1, PACKETS + 1))
    assert {d: sorted(p) for d, p in out["served"].items()} == {
        f"cam{i}": want for i in range(STREAMS)}, out
    assert out["first_batch"]["collect_to_emitted_ms"] < PERIOD_S * 1000.0, out

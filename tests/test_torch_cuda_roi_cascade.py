"""ROI serving and the temporal cascade on the card.

- An ROI engine's canvas program (its own key, ``(model, stem,
  (roi_canvas, roi_canvas), bucket)``) is captured as a CUDA graph whose
  replay equals the eager step bit for bit, with one keep-mask launch a
  replay.
- The cascade head's program (its ``cascade:`` key) replays the eager
  head's outputs bit for bit on clips gathered from a device pool; the
  pool grows on the card and keeps its rows.

Marked ``cuda``: each test skips without a GPU (decided inside a fixture).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_roi_cascade.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.collector import CanvasPacker
from video_edge_ai_proxy_tpu_torch.engine.runner import (
    InferenceEngine, _build_cascade_head, build_serving_step,
)
from video_edge_ai_proxy_tpu_torch.models.blob import BINS, blob_color
from video_edge_ai_proxy_tpu_torch.temporal import TrackStatePool
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


class _Sink:
    def publish(self, payload):
        pass


def _scene(key, x0):
    frame = np.full((64, 64, 3), 114, np.uint8)
    frame[8:30, x0:x0 + 22] = blob_color(key)
    return frame


def test_canvas_program_graph_equals_eager(card):
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_blob_gauge", batch_buckets=(1, 2, 4), roi=True, roi_canvas=64,
        roi_min_crop=8), device=card)
    eng.warmup()
    canvases, placements, _ = CanvasPacker(side=64, gap=8, max_canvases=4, min_crop=8).pack(
        [(f"c{k}", FrameMeta(width=64, height=64), _scene(k, 8 + k), (4, 4, 28, 28))
         for k in range(BINS)])
    assert len(placements) == BINS
    frames = torch.zeros((4, 64, 64, 3), dtype=torch.uint8, device=card)
    frames[:len(canvases)] = torch.from_numpy(canvases).to(card)
    eager = build_serving_step(eng._model, eng._spec, quality_thumb=eng._cfg.quality_thumb)
    with eng._compute_stream(), torch.inference_mode():
        step = eng._step((64, 64), 4)
        step(frames)
        nms_keep_mask_cuda.launches = 0
        got = step(frames)
        launches = nms_keep_mask_cuda.launches
        want = eager(frames)
    torch.cuda.synchronize()
    assert launches == 1
    assert int(got["valid"].sum()) > 0
    for k in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(got[k], want[k]), k


def test_cascade_head_graph_equals_eager(card):
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_blob_gauge", batch_buckets=(1, 2, 4), prefetch=False, track=True,
        cascade=True, cascade_model="tiny_videomae", cascade_every_n=2), device=card,
        annotations=_Sink())
    eng.warmup()
    pool = TrackStatePool(side=32, clip_len=4, device=card)
    rng = np.random.default_rng(3)
    with eng._compute_stream(), torch.inference_mode():
        for i in range(12):    # 12 tracks: the ring grows past its first 8 rows
            pool.scatter([f"t{i}"], rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8))
        first = pool.gather(*pool.gather_indices(["t0", "t11"], 4)).cpu()
        for _ in range(4):
            pool.scatter(["a", "b"], rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
                         bucket=4)
        assert pool.array.shape[0] == 16
        assert torch.equal(pool.gather(*pool.gather_indices(["t0", "t11"], 4)).cpu(), first)
        plan = pool.gather_indices(["a", "b"], 4)
        host, _ = eng._cascade_head(pool, *plan, 2)
        host2, _ = eng._cascade_head(pool, *plan, 2)
        _, module = eng._ensure_model("tiny_videomae")
        want = _build_cascade_head(module, eng._cfg.cascade_score_w,
                                   eng._cfg.cascade_score_b)(pool.gather(*plan))
    torch.cuda.synchronize()
    assert any(k[0] == "cascade:tiny_videomae" for k in eng._steps)
    for k in ("event_score", "features", "logits"):
        np.testing.assert_array_equal(host[k], host2[k])
        np.testing.assert_array_equal(host[k], want[k].cpu().numpy())

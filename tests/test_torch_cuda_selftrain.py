"""The self-training loop's card-side checks (``tiny_yolov8``):

- save -> reload -> replay: a checkpoint an engine on the card saves
  (``save_checkpoint``) reloads into a fresh engine whose serving step
  gives bit-identical outputs on one batch, and whose lockstep replay
  emits the same detections;
- the detection loss and its gradients on the card in float32 against the
  CPU's (other convolution algorithms: relative 1e-3);
- three bf16 training steps with float32 master weights and BatchNorm
  statistics: finite, falling losses, float32 parameters, moved
  statistics.

Marked ``cuda``: each test skips without a GPU (decided inside a fixture).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_selftrain.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import time

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import to_flax
from video_edge_ai_proxy_tpu_torch.models.detect_loss import make_detection_loss_fn
from video_edge_ai_proxy_tpu_torch.parallel import make_trainer
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.utils.checkpoint import save_msgpack
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


def _frames(n: int = 4, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3), np.uint8)


def _ticks():
    frames = _frames()
    meta = dict(width=64, height=48, channels=3, is_keyframe=True)
    return [[(f"cam{i}", frames[i], FrameMeta(packet=0, timestamp_ms=int(time.time() * 1000),
                                               **meta)) for i in range(len(frames))]]


def _served(engine) -> list:
    results = []
    engine._publish = results.append
    engine.serve_lockstep(_ticks())
    return sorted(((r.device_id, [(d.class_id, d.confidence, d.box.left, d.box.top,
                                   d.box.width, d.box.height) for d in r.detections])
                   for r in results))


def test_saved_checkpoint_reloads_to_a_bit_identical_step(card, tmp_path):
    model = registry.get("tiny_yolov8").init_params(torch.Generator().manual_seed(5),
                                                    device="cpu", dtype=torch.float32)
    first = str(tmp_path / "first.msgpack")
    save_msgpack(first, to_flax(zero_class_prior(model.state_dict())))
    a = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prefetch=False,
                                                       checkpoint_path=first), device=card)
    served_a = _served(a)
    saved = a.save_checkpoint(str(tmp_path / "saved.msgpack"))
    b = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prefetch=False,
                                                       checkpoint_path=saved), device=card)
    served_b = _served(b)
    assert served_a == served_b and sum(len(d) for _, d in served_a) > 0
    sa, sb = a._model.state_dict(), b._model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    spec = registry.get("tiny_yolov8")
    x = torch.from_numpy(_frames()).to(card)
    with torch.inference_mode():
        out_a = build_serving_step(a._model, spec)(x)
        out_b = build_serving_step(b._model, spec)(x)
    torch.cuda.synchronize()
    assert all(torch.equal(out_a[k], out_b[k]) for k in out_a)


def _batch(dev, n: int = 4, size: int = 128):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 1, (n, 3, size, size)).astype(np.float32)).to(dev)
    boxes = np.zeros((n, 4, 4), np.float32)
    for i in range(n - 1):
        for j in range(2):
            x1, y1 = rng.uniform(0, size * 0.6, 2)
            boxes[i, j] = [x1, y1, x1 + size / 4, y1 + size / 5]
    mask = boxes[..., 2] > 0
    t = {"boxes": torch.from_numpy(boxes).to(dev),
         "labels": torch.from_numpy(rng.integers(0, 4, (n, 4))).to(dev),
         "mask": torch.from_numpy(mask).to(dev)}
    return x, t


def test_detection_loss_on_the_card_matches_the_cpu(card):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, grads = [], []
    for dev in (torch.device("cpu"), card):
        model = registry.get("tiny_yolov8").init_params(torch.Generator().manual_seed(2),
                                                        device=dev, dtype=torch.float32)
        model.train()
        x, t = _batch(dev)
        loss = make_detection_loss_fn(model.cfg, update_stats=True)(model, x, t)
        loss.backward()
        losses.append(float(loss))
        grads.append({k: p.grad.float().cpu() for k, p in model.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3)
    for k, g in grads[0].items():
        scale = float(g.abs().max()) + 1e-6
        assert float((grads[1][k] - g).abs().max()) <= 1e-3 * scale, k


def test_bf16_steps_over_float32_weights(card):
    spec = registry.get("tiny_yolov8")
    model = spec.init_params(torch.Generator().manual_seed(3), device=card,
                             param_dtype=torch.float32)
    trainer = make_trainer(model, card, learning_rate=1e-3, clip_norm=10.0, mutable_aux=True,
                           loss_fn=make_detection_loss_fn(model.cfg, update_stats=True))
    state = trainer.init_state()
    mean0 = state.aux["stem.bn.running_mean"].clone()
    x, t = _batch(card, 8, 64)
    losses = []
    for _ in range(3):
        state, loss = trainer.train_step(state, x, t)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert model.stem.conv.compute_dtype == torch.bfloat16
    assert not torch.equal(state.aux["stem.bn.running_mean"], mean0)

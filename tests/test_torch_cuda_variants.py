"""The detection step's variants and the device accounting on the card.

- Each variant (``s2d``, ``int8``, ``int8_act``) of ``tiny_yolov8`` runs
  as the engine's CUDA graph, bit-identical to the eager step of its key.
- The int8 conv's int32 product on the card (``torch._int_mm`` over an
  im2col, zero-padded to its shape rules) equals its plain CPU version.
- The engine resolves the MFU peak from the card's name and the
  device-memory budget from the card's total memory, and notes each
  captured program's FLOPs and footprint.

Marked ``cuda``: each test skips without a GPU (decided inside a fixture).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_variants.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import copy

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.common import int8_conv2d
from video_edge_ai_proxy_tpu_torch.obs.perf import PEAK_TFLOPS_BF16
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda

HW = (96, 128)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def detector(card):
    spec = registry.get("tiny_yolov8")
    model = spec.init_params(torch.Generator().manual_seed(0), device=card)
    model.load_state_dict(zero_class_prior(model.state_dict()))
    return model


@pytest.mark.parametrize("stem,quantize", [("s2d", ""), ("classic", "int8"),
                                           ("s2d", "int8"), ("classic", "int8_act")])
def test_variant_graph_equals_eager(card, detector, stem, quantize):
    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", stem=stem,
                                                            quantize=quantize, hbm=True),
                             device=card, model=copy.deepcopy(detector))
    engine.warmup()
    assert engine.perf.peak_tflops == PEAK_TFLOPS_BF16[torch.cuda.get_device_name(card)]
    assert engine.hbm.budget_bytes == torch.cuda.mem_get_info(card)[1]
    gen = torch.Generator(device=card).manual_seed(3)
    frames = torch.randint(0, 256, (2,) + HW + (3,), generator=gen, dtype=torch.uint8,
                           device=card)
    thumbs = torch.rand((2, 32, 32), generator=gen, device=card)
    with engine._compute_stream(), torch.inference_mode():
        got = engine._step(HW, 2)(frames, thumbs)
        want = build_serving_step(engine._model, engine._spec, quality_thumb=32)(frames, thumbs)
        torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert int(got["valid"].sum()) > 0
    [rec] = engine.perf.compiles()
    assert rec["flops"] > 0
    [(key, prog)] = engine.hbm.programs().items()
    assert key == f"tiny_yolov8|{stem}|96x128|2|-" and prog["temp_bytes"] > 0
    if quantize:
        fp, q = engine.residency["tiny_yolov8"]
        assert q < fp


@pytest.mark.parametrize("m,ci,co,k,stride", [(2, 16, 24, 3, 2), (1, 5, 7, 3, 1),
                                              (4, 32, 64, 1, 1)])
def test_int8_conv_on_the_card_equals_the_cpu(card, m, ci, co, k, stride):
    rng = np.random.default_rng(4)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, ci, 9, 11), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (co, ci, k, k), dtype=np.int8))
    pad = ((k // 2, k // 2), (k // 2, k // 2))
    want = int8_conv2d(xq, wq, stride, pad)
    got = int8_conv2d(xq.to(card), wq.to(card), stride, pad)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)

"""The engine's compiled step on the card: one CUDA graph per (model,
stem, geometry, bucket) key (``engine/runner.py`` ``_GraphedStep``).

- The graphed step's outputs equal the eager ``build_serving_step``'s bit
  for bit: ``tiny_yolov8`` with the quality statistics, and a 2-layer
  VideoMAE on 16-frame clips (1568 tokens, so its attention runs the
  flash-attention kernel inside the graph).
- The outputs a replay returned are not changed by the next replays.
- A step that synchronises with the host raises at capture, and nothing
  runs it eagerly in its place; after that failed capture ``empty_cache``
  still returns freed memory to the device, and after a capture into its
  pool, which torch refuses, once ``_end_pool_recording`` ends it.
- The kernel wrappers' launch counts grow by the captured launches at
  every replay, and not at capture.
- The engine on the card serves through graphs: one capture per key,
  prewarmed by ``cfg.prewarm``, its capture time and its pool.

Marked ``cuda``: each test skips without a GPU (decided inside a fixture).
Run them on a machine with a card with

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda -q

This file imports torch and numpy only, so it runs where JAX is absent.
"""

import functools
import types

import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import runner as runner_mod
from video_edge_ai_proxy_tpu_torch.engine.runner import (
    InferenceEngine, _GraphedStep, build_serving_step,
)
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda

THUMB = 32


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
    return model, spec


@pytest.fixture(scope="module")
def video(card):
    from video_edge_ai_proxy_tpu_torch.models.transformer import EncoderConfig
    from video_edge_ai_proxy_tpu_torch.models.videomae import VideoMAE, VideoMAEConfig

    model = VideoMAE(VideoMAEConfig(num_frames=16, encoder=EncoderConfig(num_layers=2)),
                     torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    spec = types.SimpleNamespace(kind="video", input_size=224, clip_len=16)
    return model.to(card).eval(), spec


def _graphed(card, model, spec, shape, thumb=0):
    """A graphed step as the engine makes one, its stream and its captures."""
    captures = []
    step = _GraphedStep(functools.partial(build_serving_step, model, spec, quality_thumb=thumb),
                        shape, (thumb, thumb) if thumb else None, device=card,
                        pool=torch.cuda.graph_pool_handle, on_capture=captures.append)
    return step, torch.cuda.Stream(card), captures


def _inputs(card, shape, seed, thumb=0):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(card)
    if not thumb:
        return (frames,)
    prev = torch.from_numpy(rng.uniform(0, 1, (shape[0], thumb, thumb)).astype(np.float32))
    return frames, prev.to(card)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["detect", "video"])
def test_graphed_equals_eager_bit_for_bit(card, detector, video, kind):
    if kind == "detect":
        (model, spec), shape, thumb = detector, (4, 96, 128, 3), THUMB
    else:
        (model, spec), shape, thumb = video, (2, 16, 120, 160, 3), 0
    eager = build_serving_step(model, spec, quality_thumb=thumb)
    step, stream, captures = _graphed(card, model, spec, shape, thumb)
    inputs = [_inputs(card, shape, seed, thumb) for seed in range(3)]
    with torch.inference_mode():
        want = [eager(*x) for x in inputs]
        with torch.cuda.stream(stream):
            got = [step(*x) for x in inputs]     # all three held until the last ran
        torch.cuda.synchronize()
    assert len(captures) == 1 and captures[0] > 0.0
    for g, w in zip(got, want):
        _assert_equal(g, w)
    assert any(not torch.equal(got[0][k], got[1][k]) for k in got[0])   # distinct inputs


def test_a_replay_leaves_earlier_outputs_alone(card, detector):
    model, spec = detector
    shape = (2, 96, 128, 3)
    step, stream, _ = _graphed(card, model, spec, shape, THUMB)
    with torch.inference_mode(), torch.cuda.stream(stream):
        first = step(*_inputs(card, shape, 0, THUMB))
        kept = {k: v.clone() for k, v in first.items()}
        for seed in range(1, 4):
            step(*_inputs(card, shape, seed, THUMB))
        torch.cuda.synchronize()
    _assert_equal(first, kept)


def test_a_synchronising_step_raises_at_capture(card):
    calls = []

    def build():
        def step(frames):
            calls.append(1)
            # A device -> host read: the host waits for the device.
            return {"mean": frames.float().mean() + float(frames[0, 0, 0, 0])}
        return step

    step = _GraphedStep(build, (1, 8, 8, 3), None, device=card,
                        pool=torch.cuda.graph_pool_handle, on_capture=lambda s: None)
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=card)
    out = []
    with torch.cuda.stream(torch.cuda.Stream(card)):
        with pytest.raises(RuntimeError):
            out.append(step(frames))
    torch.cuda.synchronize()
    # The eager warmup calls ran, then the capture's call raised; no eager
    # call ran in its place and nothing was returned.
    assert len(calls) == _GraphedStep.WARMUP_CALLS + 1
    assert step._graph is None and not out


def test_a_failed_capture_leaves_empty_cache_working(card):
    """After a capture fails, the allocator records into no pool: a freed
    block goes back to the device at ``empty_cache``, as it would have
    before the capture."""
    def build():
        def step(frames):
            return {"mean": frames.float().mean() + float(frames[0, 0, 0, 0])}
        return step

    step = _GraphedStep(build, (1, 8, 8, 3), None, device=card,
                        pool=torch.cuda.graph_pool_handle, on_capture=lambda s: None)
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=card)
    with torch.cuda.stream(torch.cuda.Stream(card)):
        with pytest.raises(RuntimeError):
            step(frames)
    torch.cuda.synchronize()
    block = torch.empty(256 << 20, dtype=torch.uint8, device=card)
    reserved = torch.cuda.memory_reserved(card)
    del block
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(card) <= reserved - (256 << 20)


def test_a_refused_capture_into_a_failed_pool_is_ended_as_well(card):
    """torch refuses a capture into the pool of a failed one ("already
    recording") and leaves the refused capture's recording open, so that
    ``empty_cache`` releases nothing; ``_end_pool_recording`` ends it."""
    def build():
        def step(frames):
            return {"mean": frames.float().mean() + float(frames[0, 0, 0, 0])}
        return step

    pool = torch.cuda.graph_pool_handle()
    step = _GraphedStep(build, (1, 8, 8, 3), None, device=card, pool=lambda: pool,
                        on_capture=lambda s: None)
    with torch.cuda.stream(torch.cuda.Stream(card)):
        with pytest.raises(RuntimeError):
            step(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=card))

    def released() -> int:
        torch.cuda.synchronize()
        block = torch.empty(256 << 20, dtype=torch.uint8, device=card)
        reserved = torch.cuda.memory_reserved(card)
        del block
        torch.cuda.empty_cache()
        return reserved - torch.cuda.memory_reserved(card)

    side = torch.cuda.Stream(card)
    with pytest.raises(RuntimeError, match="already recording"):
        with torch.cuda.stream(side), torch.cuda.graph(torch.cuda.CUDAGraph(), pool=pool,
                                                      stream=side):
            torch.zeros(4, device=card).add_(1)
    assert released() == 0
    runner_mod._end_pool_recording(card, pool)
    assert released() >= 256 << 20


def test_launch_counts_grow_by_the_captured_launches_at_each_replay(card, detector, video):
    from video_edge_ai_proxy_tpu_torch.kernels.flash import flash_attention_fwd_cuda
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda

    cases = [(detector, (4, 96, 128, 3), THUMB, nms_keep_mask_cuda, 1),
             (video, (2, 16, 120, 160, 3), 0, flash_attention_fwd_cuda, 2)]
    for (model, spec), shape, thumb, wrapper, per_step in cases:
        step, stream, _ = _graphed(card, model, spec, shape, thumb)
        x = _inputs(card, shape, 0, thumb)
        with torch.inference_mode(), torch.cuda.stream(stream):
            wrapper.launches = 0
            step(*x)          # the eager warmup calls, the capture, one replay
            assert wrapper.launches == (_GraphedStep.WARMUP_CALLS + 1) * per_step
            for n in range(1, 4):
                step(*x)
                assert wrapper.launches == (_GraphedStep.WARMUP_CALLS + 1 + n) * per_step
        torch.cuda.synchronize()


def test_engine_serves_through_one_graph_per_key(card, detector):
    model, _ = detector
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prefetch=False,
                                                         prewarm=[[96, 128, 2]]),
                          device=card, model=model)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 2, 96, 128, 3), dtype=np.uint8)
    fold = eng.serve_lockstep([(f"cam{s}", frames[t, s], FrameMeta(packet=t)) for s in range(2)]
                              for t in range(3))
    assert fold > 0 and eng.pipeline_stats().frames == 6
    assert list(eng._steps) == [("tiny_yolov8", "classic", (96, 128), 2)]
    assert isinstance(eng._steps[("tiny_yolov8", "classic", (96, 128), 2)], _GraphedStep)
    stats = eng.graph_stats()
    assert stats["programs"] == 1 and stats["capture_s"] > 0.0 and stats["pool_bytes"] > 0
    assert [r["programs"] for r in eng.perf.compiles()] == [1]
    assert eng.prewarm_status()["complete"]


@pytest.mark.parametrize("name,thumb", [("tiny_resnet", THUMB), ("tiny_mobilenet_v2", THUMB),
                                        ("yolov8s", THUMB), ("resnet50", 0)])
def test_model_families_graphed_equal_eager(card, name, thumb):
    """The other families' steps (embed, classify, the small detector) in
    bf16: the graph replay equals eager bit for bit; yolov8s's step with
    the plain keep mask gives the same detections, and one keep-mask
    launch a replay."""
    from video_edge_ai_proxy_tpu_torch.kernels import launch_counters
    from video_edge_ai_proxy_tpu_torch.kernels.nms import nms_keep_mask_cuda
    from video_edge_ai_proxy_tpu_torch.ops.nms import nms_keep_mask_reference

    spec = registry.get(name)
    model = spec.init_params(torch.Generator().manual_seed(0), device=card)
    if spec.kind == "detect":
        model.load_state_dict(zero_class_prior(model.state_dict()))
    shape = (4, 270, 480, 3)
    eager = build_serving_step(model, spec, quality_thumb=thumb)
    step, stream, _ = _graphed(card, model, spec, shape, thumb)
    inputs = [_inputs(card, shape, seed, thumb) for seed in range(2)]
    with torch.inference_mode():
        want = [eager(*x) for x in inputs]
        with torch.cuda.stream(stream):
            got = [step(*x) for x in inputs]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _assert_equal(g, w)
        if spec.kind == "embed":
            assert tuple(got[0]["embedding"].shape) == (4, model.features)
        if spec.kind == "detect":
            plain = build_serving_step(model, spec, quality_thumb=thumb,
                                       keep_mask=nms_keep_mask_reference)(*inputs[0])
            for k in ("boxes", "scores", "classes", "valid"):
                assert torch.equal(plain[k], want[0][k]), k
            assert int(want[0]["valid"].sum()) > 0
            before = nms_keep_mask_cuda.launches
            with torch.cuda.stream(stream):
                step(*inputs[0])
            torch.cuda.synchronize()
            assert nms_keep_mask_cuda.launches - before == 1
    assert nms_keep_mask_cuda in launch_counters()


@pytest.mark.parametrize("name", ["tiny_resnet", "tiny_mobilenet_v2", "mobilenet_v2"])
def test_model_families_f32_on_the_card_match_the_cpu(card, name):
    """float32 with TF32 off, the card against the CPU on the same seeded
    weights and frames: embeddings within 1e-4 of their largest entry,
    classifier top-5 ids equal."""
    spec = registry.get(name)
    models = [spec.init_params(torch.Generator().manual_seed(0), device=d, dtype=torch.float32)
              for d in (card, "cpu")]
    frames = _inputs(card, (2, 270, 480, 3), 5)[0]
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got, want = (build_serving_step(m, spec, preprocess_dtype=torch.float32)(f)
                     for m, f in zip(models, (frames, frames.cpu())))
    if spec.kind == "embed":
        err = (got["embedding"].cpu() - want["embedding"]).abs().max()
        assert float(err / want["embedding"].abs().max()) <= 1e-4
    else:
        assert torch.equal(got["top_ids"].cpu(), want["top_ids"])

"""The port's classify / video serving slice against the JAX package's.

- float32: the port's ``build_serving_step`` against the JAX classify /
  video branch composed from the same public functions in float32
  (``tiny_videomae`` on 2 clips of 4x48x64 uint8 frames, ``tiny_vit`` on
  2 frames of 48x64): top-5 probabilities within 1e-3, and the top ids
  equal wherever neighbouring probabilities are more than 1e-3 apart.
- bf16: the JAX ``build_serving_step`` itself against the port's bf16
  step. bf16 rounds the activations at other points in the two
  frameworks; over a 5- or 10-way softmax that moves probabilities by a
  few 1e-3 (3.6e-3 measured on ``tiny_vit``), so the bar is 0.02, with
  ids equal wherever neighbouring probabilities are more than 0.02 apart.
- The collector's clip windows, and the engine once per model kind:
  ``InferenceEngine(device="cpu")`` on 2 streams until each stream's clip
  window has filled and produced results.
"""

import threading
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.engine.runner import build_serving_step as jbuild_serving_step
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import videomae as jvmae
from video_edge_ai_proxy_tpu.models import vit as jvit
from video_edge_ai_proxy_tpu.ops import preprocess as jpre
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.collector import Collector
from video_edge_ai_proxy_tpu_torch.engine.runner import (
    Detection, InferenceEngine, build_serving_step, to_detections,
)
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import load_flax
from video_edge_ai_proxy_tpu_torch.ops import preprocess as tpre
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

F32_TOL = 1e-3
BF16_TOL = 0.02

CASES = {
    "tiny_videomae": (lambda dtype: jvmae.VideoMAE(jvmae.tiny_videomae_config(), dtype=dtype),
                      (2, 4, 48, 64, 3)),
    "tiny_vit": (lambda dtype: jvit.ViT(jvit.tiny_vit_config(), dtype=dtype), (2, 48, 64, 3)),
}


def _weights(name):
    """flax init of the JAX model with every bias and embedding drawn from
    a numpy seed, unboxed, as numpy."""
    jbuild, shape = CASES[name]
    v = jax.jit(jbuild(jnp.float32).init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1,) + shape[1:-3] + (32, 32, 3)))
    rng = np.random.default_rng(0)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(val, path + (k,)) for k, val in node.items()}
        if path[-1] in ("bias", "pos_embed", "cls_token"):
            return rng.normal(0.0, 0.2, node.shape).astype(np.float32)
        return np.asarray(node, np.float32)
    return walk(fnn.meta.unbox(v), ())


def _frames(name, seed=1):
    return np.random.default_rng(seed).integers(0, 256, CASES[name][1], dtype=np.uint8)


def _jax_f32(name, variables, frames):
    jmodel = CASES[name][0](jnp.float32)
    pre = jpre.preprocess_clip if frames.ndim == 5 else jpre.preprocess_classify
    x = pre(jnp.asarray(frames), (32, 32), out_dtype=jnp.float32)
    probs = jax.nn.softmax(jmodel.apply(variables, x), axis=-1)
    top_p, top_i = jax.lax.top_k(probs, 5)
    return np.asarray(top_p), np.asarray(top_i)


def _assert_top5(got_p, got_i, want_p, want_i, tol):
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=tol)
    gaps = np.abs(np.diff(want_p, axis=-1))
    separated = np.ones_like(want_p, dtype=bool)
    separated[:, 1:] &= gaps > tol
    separated[:, :-1] &= gaps > tol
    np.testing.assert_array_equal(got_i[separated], want_i[separated])


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_step_f32_matches_jax(name):
    variables, frames = _weights(name), _frames(name)
    want_p, want_i = _jax_f32(name, variables, frames)
    spec = registry.get(name)
    model = load_flax(spec.build(torch.float32), variables).eval()
    out = build_serving_step(model, spec, quality_thumb=32,
                             preprocess_dtype=torch.float32)(torch.from_numpy(frames))
    want_keys = {"top_probs", "top_ids"} | (set() if spec.clip_len else
                                             {"quality_stats", "quality_thumbs"})
    assert set(out) == want_keys
    assert out["top_probs"].dtype == torch.float32 and out["top_ids"].dtype == torch.int32
    assert out["top_ids"].shape == (2, 5)
    _assert_top5(out["top_probs"].numpy(), out["top_ids"].numpy(), want_p, want_i, F32_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_step_bf16_matches_jax(name):
    variables, frames = _weights(name), _frames(name, seed=2)
    jspec = jregistry.get(name)
    want = jax.jit(jbuild_serving_step(jspec.build(), jspec))(variables, jnp.asarray(frames))
    spec = registry.get(name)
    model = load_flax(spec.build(torch.bfloat16), variables).eval()
    got = build_serving_step(model, spec)(torch.from_numpy(frames))
    _assert_top5(got["top_probs"].numpy(), got["top_ids"].numpy(),
                 np.asarray(want["top_probs"]), np.asarray(want["top_ids"]), BF16_TOL)


def test_preprocess_classify_and_clip_match_jax():
    frames = _frames("tiny_videomae", seed=3)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 2e-4),
                               (torch.bfloat16, jnp.bfloat16, 2.0 ** -6)):
        want = np.asarray(jpre.preprocess_clip(jnp.asarray(frames), (32, 32), out_dtype=jdtype),
                          np.float32)
        got = tpre.preprocess_clip(torch.from_numpy(frames), (32, 32), out_dtype=dtype)
        assert got.dtype == dtype and got.shape == (2, 4, 32, 32, 3)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    flat = frames[:, 0]
    np.testing.assert_array_equal(
        tpre.preprocess_classify(torch.from_numpy(flat), (32, 32), out_dtype=torch.float32).numpy(),
        tpre.preprocess_clip(torch.from_numpy(frames), (32, 32),
                             out_dtype=torch.float32)[:, 0].numpy())


def test_top5_to_detections():
    host = {"top_probs": np.array([[0.5, 0.2, 0.1, 0.1, 0.1]], np.float32),
            "top_ids": np.array([[3, 0, 4, 1, 2]], np.int32)}
    dets = to_detections(host, 0, "video", 5)
    assert [d.class_id for d in dets] == [3, 0, 4, 1, 2]
    assert [d.class_name for d in dets] == ["3", "0", "4", "1", "2"]
    assert dets[0].confidence == pytest.approx(0.5) and dets[0].box.width == 0


def _frame(value, hw=(48, 64)):
    return np.full(hw + (3,), value, np.uint8)


def test_collector_builds_clip_windows():
    bus = MemoryFrameBus()
    for s in ("a", "b"):
        bus.create_stream(s, 48 * 64 * 3)
    col = Collector(bus, buckets=(1, 2, 4), clip_len=3)
    for value in (1, 2):
        for s in ("a", "b"):
            bus.publish(s, _frame(value), FrameMeta(packet=value))
        assert col.collect() == []                   # no sample until full
    bus.publish("a", _frame(3), FrameMeta(packet=3))
    bus.publish("b", _frame(9), FrameMeta(packet=3))
    bus.publish("b", _frame(4), FrameMeta(packet=4))  # latest wins: 9 is skipped
    (group,) = col.collect()
    assert group.device_ids == ["a", "b"] and group.bucket == 2
    assert group.frames.shape == (2, 3, 48, 64, 3)
    assert [int(f[0, 0, 0]) for f in group.frames[0]] == [1, 2, 3]
    assert [int(f[0, 0, 0]) for f in group.frames[1]] == [1, 2, 4]
    assert [m.packet for m in group.metas] == [3, 4]
    bus.publish("a", _frame(5), FrameMeta(packet=5))
    (group,) = col.collect()                         # the window slides by one
    assert [int(f[0, 0, 0]) for f in group.frames[0]] == [2, 3, 5]
    bus.publish("a", _frame(6, (32, 32)), FrameMeta(packet=6))
    assert col.collect() == []                       # new geometry: a new clip
    col.clip_len = 2                                 # a new clip length: new windows
    bus.publish("a", _frame(7, (32, 32)), FrameMeta(packet=7))
    bus.publish("b", _frame(8), FrameMeta(packet=8))
    assert col.collect() == []
    bus.publish("a", _frame(10, (32, 32)), FrameMeta(packet=10))
    (group,) = col.collect()
    assert group.device_ids == ["a"] and group.frames.shape == (1, 2, 32, 32, 3)


class _ReadTrackingBus(MemoryFrameBus):
    """A memory bus that records the newest seq the collector has read, so
    a feeder can publish one frame per stream per tick."""

    def __init__(self):
        super().__init__()
        self.read = {}

    def read_latest(self, device_id, min_seq=0):
        frame = super().read_latest(device_id, min_seq)
        if frame is not None:
            self.read[device_id] = frame.seq
        return frame

    def read_latest_into(self, device_id, dst, min_seq=0):
        # The collector's pooled fast path (streams of known geometry).
        res = super().read_latest_into(device_id, dst, min_seq)
        if isinstance(res, tuple):
            self.read[device_id] = res[0]
        return res


@pytest.mark.parametrize("name", ["tiny_videomae", "tiny_vit"])
def test_engine_serves_two_streams(name):
    bus = _ReadTrackingBus()
    streams = ["cam0", "cam1"]
    for s in streams:
        bus.create_stream(s, 48 * 64 * 3)
    engine = InferenceEngine(bus, EngineConfig(model=name, tick_ms=5), device="cpu")
    results = engine.subscribe()
    got: dict = {}

    def consume():
        for r in results:
            got.setdefault(r.device_id, []).append(r)

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    engine.start()
    rng = np.random.default_rng(4)
    try:
        deadline = time.monotonic() + 60
        packet = 0
        while any(len(got.get(s, [])) < 2 for s in streams):
            assert time.monotonic() < deadline, "streams not served in time"
            packet += 1
            # Frames made first, then published back to back, so that a
            # tick does not fall between the two streams' publishes.
            frames = {s: rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for s in streams}
            stamp = int(time.time() * 1000)
            seqs = {s: bus.publish(s, frames[s], FrameMeta(packet=packet, timestamp_ms=stamp))
                    for s in streams}
            while any(bus.read.get(s, 0) < seq for s, seq in seqs.items()):
                assert time.monotonic() < deadline, "collector stopped reading"
                time.sleep(0.002)
    finally:
        engine.stop()
    reader.join(5)
    assert not reader.is_alive()
    clip_len = registry.get(name).clip_len
    for s in streams:
        first = got[s][0]
        assert first.model == name and first.batch_size == 2
        # A clip model's first result comes from the clip_len-th frame.
        assert first.frame_packet == max(clip_len, 1)
        for r in got[s]:
            assert len(r.detections) == 5
            assert all(isinstance(d, Detection) and d.box.width == 0 for d in r.detections)
            assert len({d.class_id for d in r.detections}) == 5
            confs = [d.confidence for d in r.detections]
            assert confs == sorted(confs, reverse=True) and 0.0 < sum(confs) <= 1.0 + 1e-6

"""Serving a trained checkpoint through the port, against the JAX package, on
the CPU (``tiny_yolov8`` in float32 on both sides):

- An engine with ``checkpoint_path`` (a JAX-written msgpack whose metadata
  carries a calibrated ``conf_threshold``) loads the checkpoint's weights
  at warmup and emits, frame for frame, the detections JAX's
  ``_to_detections`` gives on the JAX engine's own loaded state: the same
  count and classes, boxes within 1 px, confidences within 2e-4, the
  detections under the threshold left out; extra per-stream models keep
  the NMS floor.
- The repaired fault: a port ``Server`` built from a YAML file with
  ``engine.checkpoint_path`` serves the checkpoint and its threshold, as
  JAX's ``Server`` from the same file does (the port's config had no such
  key and served random weights without a word).
- A missing checkpoint logs a warning and keeps the random init, as in
  JAX; ``save_checkpoint`` is refused before warmup, writes what JAX's
  ``load_msgpack`` reads back against its own template, and from a
  quantized engine writes the dequantized weights with a warning.
"""

import functools
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JaxBus
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.replay import checksum as jchecksum
from video_edge_ai_proxy_tpu.utils import checkpoint as jck
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JaxEngineConfig
from video_edge_ai_proxy_tpu.utils.config import load_config as jax_load_config
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax, to_flax
from video_edge_ai_proxy_tpu_torch.models.quantize import dequantize_tree
from video_edge_ai_proxy_tpu_torch.utils import checkpoint as ck
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig, load_config

from test_torch_selftrain import _variables as selftrain_variables  # noqa: E402

TOL = 2e-4
STREAMS = ("cam0", "cam1", "cam2")


def _variables() -> dict:
    """tiny_yolov8's twin weights (``test_torch_selftrain._variables``) with
    the class prior zeroed, so NMS sees real candidates."""
    return jax.tree_util.tree_map(np.asarray, jchecksum.zero_class_prior(selftrain_variables()))


def _ticks():
    rng = np.random.default_rng(1)
    ticks = []
    for t in range(2):
        tick = []
        for i, dev in enumerate(STREAMS):
            frame = rng.integers(0, 256, (48, 64, 3), np.uint8)
            tick.append((dev, frame, FrameMeta(width=64, height=48, channels=3, packet=t,
                                               is_keyframe=True,
                                               timestamp_ms=int(time.time() * 1000))))
        ticks.append(tick)
    return ticks


@functools.cache
def _jax_step():
    spec = jregistry.get("tiny_yolov8")
    net = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    return jax.jit(jrunner.build_serving_step(net, spec))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written checkpoint of the twin weights whose metadata carries a
    threshold between two detection scores, far (> 1e-3) from every score,
    with detections on both sides of it. -> (path, threshold, variables)."""
    v = _variables()
    step = _jax_step()
    scores = []
    for tick in _ticks():
        host = step(v, jnp.asarray(np.stack([f for _, f, _ in tick])))
        scores += list(np.asarray(host["scores"])[np.asarray(host["valid"])])
    scores = np.sort(np.asarray(scores, np.float64))
    gaps = [(scores[i + 1] - scores[i], i) for i in range(len(scores) // 4,
                                                            3 * len(scores) // 4)]
    gap, i = max(gaps)
    assert gap > 2e-3 and len(scores) >= 8
    thr = float((scores[i] + scores[i + 1]) / 2)
    path = str(tmp_path_factory.mktemp("ck") / "tiny_yolov8.msgpack")
    jck.save_msgpack(path, v, meta={"conf_threshold": thr, "calibration_images": 12})
    return path, thr, v


def _served(engine) -> dict:
    """Every result the engine emits over ``_ticks()``, by stream, in order."""
    results = []
    engine._publish = results.append
    engine.serve_lockstep(_ticks())
    out: dict = {}
    for r in results:
        out.setdefault(r.device_id, []).append(r.detections)
    return out


def _jax_served(jeng) -> dict:
    """JAX's ``_to_detections`` on the JAX engine's own loaded state, over the
    same frames (its serving step built in float32)."""
    step = _jax_step()
    out: dict = {}
    for tick in _ticks():
        host = {k: np.asarray(v) for k, v in step(
            jeng._variables, jnp.asarray(np.stack([f for _, f, _ in tick]))).items()}
        for i, (dev, _, _) in enumerate(tick):
            out.setdefault(dev, []).append(
                jrunner.InferenceEngine._to_detections(jeng, host, i, jeng._spec))
    return out


def _assert_same_detections(got: dict, want: dict, thr: float, v: dict) -> None:
    step = _jax_step()
    unfiltered = sum(int(np.asarray(step(v, jnp.asarray(np.stack([f for _, f, _ in t])))
                                    ["valid"]).sum()) for t in _ticks())
    assert sorted(got) == sorted(want) == list(STREAMS)
    n = 0
    for dev in STREAMS:
        assert len(got[dev]) == len(want[dev]) == 2
        for g, w in zip(got[dev], want[dev]):
            assert len(g) == len(w), dev
            for a, b in zip(g, w):
                assert a.class_id == b.class_id and a.class_name == b.class_name
                assert a.confidence >= thr and abs(a.confidence - b.confidence) <= TOL
                for k in ("left", "top", "width", "height"):
                    assert abs(getattr(a.box, k) - getattr(b.box, k)) <= 1, (dev, k)
                n += 1
    assert 0 < n < unfiltered            # the threshold left some detections out


def _jax_engine(path: str):
    jeng = jrunner.InferenceEngine(JaxBus(), JaxEngineConfig(model="tiny_yolov8",
                                                             checkpoint_path=path))
    jeng.warmup()
    return jeng


def test_engine_serves_the_checkpoint_at_its_threshold_as_jax(checkpoint):
    path, thr, v = checkpoint
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", dtype="float32", prefetch=False, checkpoint_path=path),
        device="cpu")
    got = _served(eng)
    jeng = _jax_engine(path)
    assert eng._conf_threshold == jeng._conf_threshold == thr
    state = eng._model.state_dict()
    for k, t in from_flax(v).items():
        assert torch.equal(state[k], t), k
    _assert_same_detections(got, _jax_served(jeng), thr, v)
    # the calibrated point rides the default model only
    assert eng._threshold_of(eng._spec) == thr
    assert eng._threshold_of(registry.get("tiny_yolov8_s2d")) == 0.0


def test_server_from_yaml_serves_the_checkpoint_as_jax(checkpoint, tmp_path):
    """Fails without the repair: the port's config dropped the key."""
    from video_edge_ai_proxy_tpu.serve.server import Server as JaxServer
    from video_edge_ai_proxy_tpu_torch.serve.server import Server

    path, thr, v = checkpoint
    conf = tmp_path / "conf.yaml"
    conf.write_text(
        "bus:\n  backend: memory\n"
        "engine:\n  model: tiny_yolov8\n  dtype: float32\n  prefetch: false\n"
        f"  batch_buckets: [1, 2, 4]\n  checkpoint_path: {path}\n")
    cfg = load_config(str(conf))
    assert cfg.engine.checkpoint_path == path
    srv = Server(cfg, data_dir=str(tmp_path / "port"), enable_engine=True, device="cpu")
    jsrv = JaxServer(jax_load_config(str(conf)), data_dir=str(tmp_path / "jax"),
                     enable_engine=True)
    jsrv.engine.warmup()
    got = _served(srv.engine)
    assert srv.engine._conf_threshold == jsrv.engine._conf_threshold == thr
    _assert_same_detections(got, _jax_served(jsrv.engine), thr, v)


def test_missing_checkpoint_keeps_the_random_init(tmp_path, caplog):
    missing = str(tmp_path / "nope.msgpack")
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", dtype="float32", checkpoint_path=missing), device="cpu")
    fresh = registry.get("tiny_yolov8").init_params(device="cpu", dtype=torch.float32)
    with caplog.at_level(logging.WARNING):
        eng.warmup()
    assert any("missing; using random init" in r.getMessage() for r in caplog.records)
    assert eng._conf_threshold == 0.0
    state = eng._model.state_dict()
    assert all(torch.equal(state[k], t) for k, t in fresh.state_dict().items())


def test_save_checkpoint_round_trips_through_jax(checkpoint, tmp_path, caplog):
    path, _, v = checkpoint
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", dtype="float32", checkpoint_path=path), device="cpu")
    out = str(tmp_path / "saved.msgpack")
    with pytest.raises(RuntimeError, match="before warmup"):
        eng.save_checkpoint(out)
    eng.warmup()
    assert eng.save_checkpoint(out) == out
    template = jax.tree_util.tree_map(np.zeros_like, v)
    back = jck.load_msgpack(out, template)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        assert np.array_equal(np.asarray(a), b)
    # the same bytes as the checkpoint it loaded (no metadata written)
    jck.save_msgpack(str(tmp_path / "plain.msgpack"), v)
    with open(out, "rb") as f1, open(str(tmp_path / "plain.msgpack"), "rb") as f2:
        assert f1.read() == f2.read()
    pathless = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8"),
                               device="cpu")
    pathless.warmup()
    with pytest.raises(ValueError, match="no checkpoint path"):
        pathless.save_checkpoint()

    q = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", dtype="float32", quantize="int8", checkpoint_path=path),
        device="cpu")
    q.warmup()
    qout = str(tmp_path / "dequantized.msgpack")
    with caplog.at_level(logging.WARNING):
        q.save_checkpoint(qout)
    assert any("int8-roundtripped" in r.getMessage() for r in caplog.records)
    want = to_flax(dequantize_tree(q._model.qt))
    got = ck.load_msgpack(qout)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)
    moved = [not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                                      jax.tree_util.tree_leaves(v))]
    assert any(moved)                   # lossy against the loaded weights
    assert os.path.getsize(qout) == os.path.getsize(out)

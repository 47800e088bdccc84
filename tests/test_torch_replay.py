"""The port's replay plane against the JAX package's.

- ``device_checksum`` / ``fold_checksum`` / ``host_slot_checksum`` equal
  the JAX functions exactly on the same seeded output dicts (detect,
  classify and embed forms, with int32 wraparound).
- Traces are cross-readable: what the JAX recorder writes, the port's
  ``TracePlayer`` reads event for event and frame for frame, and the
  reverse.
- ``lockstep_checksum`` on ``tiny_yolov8`` in float32 on the CPU: two runs
  are bit-identical, a one-element weight perturbation moves the fold, and
  the frame, batch and streams-per-batch counts equal the JAX
  ``lockstep_checksum``'s on the same trace.
- Per batch of that replay, the port's detections agree with the JAX
  detect branch composed in float32 on the same ``from_flax`` weights:
  valid and classes equal, boxes (px) and scores within TOL = 1e-3 (the
  bar of ``tests/test_torch_serving.py``). Per slot, ``host_slot_checksum``
  is equal, or every term that differs is a box coordinate or a
  score * 1000 whose two values lie within TOL (TOL * 1000 for the score
  term) of each other on the two sides of a rounding boundary k + 0.5.
- The engine on the CPU with the transfer thread and the drain thread
  folds the same result checksum as with synchronous placement and an
  inline drain.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.ops import nms as jnms
from video_edge_ai_proxy_tpu.ops import preprocess as jpre
from video_edge_ai_proxy_tpu.replay import checksum as jchecksum
from video_edge_ai_proxy_tpu.replay import harness as jharness
from video_edge_ai_proxy_tpu.replay import player as jplayer
from video_edge_ai_proxy_tpu.replay import recorder as jrecorder
from video_edge_ai_proxy_tpu.replay import trace as jtrace
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
from video_edge_ai_proxy_tpu_torch.replay import checksum, player, recorder, trace
from video_edge_ai_proxy_tpu_torch.replay.harness import lockstep_checksum
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

TOL = 1e-3
STREAMS = ["cam0", "cam1", "cam2"]


# -- checksums -------------------------------------------------------------------


def _detect_out(rng, b, k, scale):
    boxes = rng.normal(0, scale, (b, k, 4)).astype(np.float32)
    boxes[:, :3] = np.float32(0.5) + rng.integers(-50, 50, (b, 3, 4))   # ties to even
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    scores[:, :4] = np.array([0.0005, 0.0015, 0.9995, 0.5005], np.float32)
    return {"boxes": boxes, "scores": scores,
            "classes": rng.integers(0, 80, (b, k)).astype(np.int32),
            "valid": rng.uniform(size=(b, k)) < 0.7}


@pytest.mark.parametrize("scale", [1e2, 1e6, 1.5e7])   # the last two wrap int32
@pytest.mark.parametrize("b,k", [(1, 100), (16, 100), (3, 7)])
def test_detect_checksums_equal_jax(scale, b, k):
    rng = np.random.default_rng(int(scale) + b)
    out = _detect_out(rng, b, k, scale)
    want = int(jchecksum.device_checksum({n: jnp.asarray(v) for n, v in out.items()}))
    got = checksum.device_checksum({n: torch.from_numpy(v) for n, v in out.items()})
    assert got.dtype == torch.int32 and int(got) == want
    folded = checksum.fold_checksum(12345, {n: torch.from_numpy(v) for n, v in out.items()})
    jfolded = jchecksum.fold_checksum(jnp.int32(12345), {n: jnp.asarray(v) for n, v in out.items()})
    assert checksum.finalize_checksum(folded) == jchecksum.finalize_checksum(jfolded)
    for i in range(b):
        assert checksum.host_slot_checksum(out, i) == jchecksum.host_slot_checksum(out, i)


@pytest.mark.parametrize("form", ["classify", "embed"])
def test_classify_and_embed_checksums_equal_jax(form):
    rng = np.random.default_rng(5)
    if form == "classify":
        out = {"top_probs": rng.uniform(0, 1, (8, 5)).astype(np.float32),
               "top_ids": rng.integers(0, 2 ** 30, (8, 5)).astype(np.int32)}   # wraps
    else:
        out = {"embedding": rng.normal(0, 1e6, (8, 512)).astype(np.float32)}
    want = int(jchecksum.device_checksum({n: jnp.asarray(v) for n, v in out.items()}))
    assert int(checksum.device_checksum({n: torch.from_numpy(v) for n, v in out.items()})) == want


def test_goldens_are_the_ports_own_and_record_only(tmp_path):
    assert checksum.GOLDENS_PATH != jchecksum.GOLDENS_PATH
    assert checksum.golden_lookup("lockstep:yolov8n:cuda") is None
    path = tmp_path / "goldens.json"
    path.write_text(json.dumps({"k": 7}))
    assert checksum.check_golden("k", 7, tool="t", path=str(path)) == 7
    assert checksum.check_golden("other", 1, tool="t", path=str(path)) is None
    with pytest.raises(RuntimeError, match="drift"):
        checksum.check_golden("k", 8, tool="t", path=str(path))


def test_zero_class_prior_equals_jax():
    """Through from_flax, the same flax tree zeroed on either side."""
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jchecksum.zero_class_prior(v)))
    got = checksum.zero_class_prior(from_flax(v))
    assert set(got) == set(want)
    assert all(torch.equal(got[n], want[n]) for n in want)


# -- traces ------------------------------------------------------------------------


def _write_mixed(mod_trace, mod_recorder, path):
    """A trace with synthetic events and lossless payload events."""
    rec = mod_recorder.TraceRecorder(str(path))
    rng = np.random.default_rng(9)
    for n in range(3):
        for d in ("a", "b"):
            meta = FrameMeta(pts=n * 3000, dts=n * 3000, is_keyframe=n == 0, packet=n,
                             timestamp_ms=1_700_000_000_000 + n * 33)
            if d == "a":
                rec.record_frame(d, mod_trace.decode_frame(
                    {"synth": {"w": 40, "h": 24, "n": n}}), meta,
                    synth={"w": 40, "h": 24, "n": n})
            else:
                rec.record_frame(d, rng.integers(0, 256, (24, 40, 3), dtype=np.uint8), meta)
    rec.close()


def _frames(mod_player, path):
    p = mod_player.TracePlayer(str(path))
    out = []
    for dev, frame, meta in p.iter_frames():
        out.append((dev, frame, meta.timestamp_ms, meta.pts, meta.packet, meta.is_keyframe,
                    meta.frame_type, meta.width, meta.height))
    return p, out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_traces_are_cross_readable(tmp_path, writer):
    wtrace, wrec = (jtrace, jrecorder) if writer == "jax" else (trace, recorder)
    synth = tmp_path / "synth.vtrace"
    wrec.record_synthetic_trace(str(synth), STREAMS, width=48, height=32, fps=30.0, frames=4)
    mixed = tmp_path / "mixed.vtrace"
    _write_mixed(wtrace, wrec, mixed)
    for path in (synth, mixed):
        jheader, jevents = jtrace.read_trace(str(path))
        header, events = trace.read_trace(str(path))
        assert (header, events) == (jheader, jevents)
        assert trace.trace_devices(events) == jtrace.trace_devices(jevents)
        assert list(trace.iter_frames(events, "a")) == list(jtrace.iter_frames(jevents, "a"))
        jp, want = _frames(jplayer, path)
        p, got = _frames(player, path)
        assert p.devices == jp.devices and len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[0] == w[0] and g[2:] == w[2:]
            np.testing.assert_array_equal(g[1], w[1])
    # A torn final line keeps the valid prefix on both sides.
    with open(mixed, "a") as fh:
        fh.write('{"ev": "frame", "dev')
    assert trace.read_trace(str(mixed)) == jtrace.read_trace(str(mixed))


def test_recording_bus_records_every_publish(tmp_path):
    path = tmp_path / "bus.vtrace"
    rec = recorder.TraceRecorder(str(path))
    bus = recorder.RecordingBus(MemoryFrameBus(), rec)
    bus.create_stream("cam0", 16 * 16 * 3)
    frames = [np.full((16, 16, 3), v, np.uint8) for v in (3, 5)]
    for n, f in enumerate(frames):
        bus.publish("cam0", f, FrameMeta(packet=n, timestamp_ms=100 + n))
    rec.close()
    assert bus.read_latest("cam0").seq == 2
    got = [(meta.packet, frame) for _, frame, meta in jplayer.TracePlayer(str(path)).iter_frames()]
    assert [p for p, _ in got] == [0, 1]
    for (_, g), f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


# -- lockstep replay ------------------------------------------------------------------


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("replay") / "lockstep.vtrace"
    return recorder.record_synthetic_trace(str(path), STREAMS, width=128, height=96, fps=30.0,
                                           frames=4)


@pytest.fixture(scope="module")
def variables():
    """A flax init of tiny_yolov8 with randomised BatchNorm terms (so the
    network is not near-identity), as numpy."""
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(0)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(val, path + (k,)) for k, val in node.items()}
        if path[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, node.shape).astype(np.float32)
        if path[-1] == "mean" or (path[-1] == "bias" and "bn" in path):
            return rng.normal(0.0, 0.2, node.shape).astype(np.float32)
        return np.asarray(node, np.float32)
    return walk(v, ())


def _lockstep(trace_path, variables, **kw):
    return lockstep_checksum(trace_path, model="tiny_yolov8", device="cpu",
                             state_dict=from_flax(variables), dtype=torch.float32,
                             preprocess_dtype=torch.float32, **kw)


def test_lockstep_is_deterministic_and_moved_by_a_perturbation(trace_path):
    def run(**kw):
        return lockstep_checksum(trace_path, model="tiny_yolov8", device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 dtype=torch.float32, preprocess_dtype=torch.float32, **kw)

    first = run()
    second = run()
    assert first == second
    assert first["frames"] == 12 and first["checksum"] > 0

    def perturb(sd):
        # One element of the stem conv, the first layer, as the JAX
        # package's replay test perturbs the first weight of its tree.
        sd = dict(sd)
        w = sd["stem.conv.weight"].clone()
        w[(0,) * w.ndim] += 0.25
        sd["stem.conv.weight"] = w
        return sd

    moved = run(perturb=perturb)
    assert moved["checksum"] != first["checksum"]
    assert (moved["frames"], moved["batches"]) == (first["frames"], first["batches"])


def test_lockstep_counts_equal_jax(trace_path, monkeypatch):
    streams_per_batch = []
    collect = jcollector.Collector.collect

    def spy(self, *args, **kwargs):
        groups = collect(self, *args, **kwargs)
        streams_per_batch.extend(len(g.device_ids) for g in groups)
        return groups

    monkeypatch.setattr(jcollector.Collector, "collect", spy)
    want = jharness.lockstep_checksum(trace_path, model="tiny_yolov8")
    got = lockstep_checksum(trace_path, model="tiny_yolov8", device="cpu", dtype=torch.float32,
                            preprocess_dtype=torch.float32)
    assert (got["frames"], got["batches"], got["model"]) == \
        (want["frames"], want["batches"], want["model"])
    assert got["batch_streams"] == streams_per_batch


@jax.jit
def _jax_detect_f32(variables, frames_u8):
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    x, lb = jpre.preprocess_letterbox(frames_u8, 64, out_dtype=jnp.float32)
    boxes, max_logit, cls_ids = model.apply(variables, x, decode="serving")
    b, s, c, valid = jnms.batched_nms(boxes, jax.nn.sigmoid(max_logit), cls_ids,
                                      use_pallas=False)
    return {"boxes": jpre.unletterbox_boxes(b, lb), "scores": s, "classes": c, "valid": valid}


def _straddles(a: float, b: float, tol: float) -> bool:
    """a and b within tol of each other, on the two sides of a k + 0.5."""
    lo, hi = min(a, b), max(a, b)
    return hi - lo <= tol and np.floor(lo + 0.5) != np.floor(hi + 0.5)


def test_lockstep_batches_agree_with_jax_detect(trace_path, variables):
    jvars = jax.tree_util.tree_map(np.asarray, jchecksum.zero_class_prior(variables))
    seen = {"slots": 0, "dets": 0, "equal": 0}

    def on_batch(group, outputs):
        got = {k: v.numpy() for k, v in outputs.items()}
        want = {k: np.asarray(v) for k, v in
                _jax_detect_f32(jvars, jnp.asarray(np.array(group.frames))).items()}
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
        for i in range(len(group.device_ids)):
            seen["slots"] += 1
            valid = got["valid"][i]
            seen["dets"] += int(valid.sum())
            if checksum.host_slot_checksum(got, i) == jchecksum.host_slot_checksum(want, i):
                seen["equal"] += 1
                continue
            for j in np.nonzero(valid)[0]:
                for a, b in zip(got["boxes"][i, j], want["boxes"][i, j]):
                    if np.round(a) != np.round(b):
                        assert _straddles(float(a), float(b), TOL), (a, b)
                a, b = 1000.0 * float(got["scores"][i, j]), 1000.0 * float(want["scores"][i, j])
                if np.round(a) != np.round(b):
                    assert _straddles(a, b, 1000.0 * TOL), (a, b)

    _lockstep(trace_path, variables, on_batch=on_batch)
    assert seen["slots"] == 12 and seen["dets"] > 0
    assert seen["equal"] >= seen["slots"] // 2


# -- the engine: pipelined against synchronous ------------------------------------------


def _engine_fold(trace_path, variables, prefetch):
    engine = InferenceEngine(MemoryFrameBus(),
                             EngineConfig(model="tiny_yolov8", prefetch=prefetch), device="cpu")
    engine._model = engine._spec.init_params(device="cpu", dtype=torch.float32)
    engine._model.load_state_dict(checksum.zero_class_prior(from_flax(variables)))
    by_packet: dict = {}
    for dev, frame, meta in player.TracePlayer(trace_path).iter_frames():
        by_packet.setdefault(meta.packet, []).append((dev, frame, meta))
    fold = engine.serve_lockstep(by_packet[p] for p in sorted(by_packet))
    return fold, engine.pipeline_stats()


def test_engine_prefetch_and_drain_fold_like_the_synchronous_path(trace_path, variables):
    piped, p_stats = _engine_fold(trace_path, variables, True)
    sync, s_stats = _engine_fold(trace_path, variables, False)
    assert piped == sync > 0
    assert p_stats.frames == s_stats.frames == 12
    assert p_stats.batches == s_stats.batches == 4

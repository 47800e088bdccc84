"""The device accounting (``obs/perf.py``) against the JAX package's
``PerfTracker``, the FLOP count, the MFU peak, and the engine's hooks and
variant keys against the JAX engine's.

The tracker's numbers are host arithmetic on the same inputs and must be
equal. The FLOP count is held two ways: exactly against an analytic count
of the port's own conv and matrix-product shapes (FlopCounterMode's
formulas), and against XLA's cost analysis of the JAX step within
[1.0, 1.25]: the port counts every tap of a padded conv, XLA only the
taps inside its input (2048 against 4608 for a 3x3 conv on a 2x2 plane),
and XLA adds elementwise work the port does not count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import aot_cache as jaot
from video_edge_ai_proxy_tpu.engine.runner import InferenceEngine as JInferenceEngine
from video_edge_ai_proxy_tpu.engine.runner import build_serving_step as jbuild_serving_step
from video_edge_ai_proxy_tpu.models import registry as jregistry
from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs import slo as jslo
from video_edge_ai_proxy_tpu.obs.perf import PerfTracker as JPerfTracker
from video_edge_ai_proxy_tpu.obs.perf import cost_summary
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import aot_cache
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, build_serving_step
from video_edge_ai_proxy_tpu_torch.models import registry
from video_edge_ai_proxy_tpu_torch.models.carry import load_flax
from video_edge_ai_proxy_tpu_torch.models.common import int8_conv2d
from video_edge_ai_proxy_tpu_torch.models.yolov8 import YOLOv8, tiny_yolov8_config
from video_edge_ai_proxy_tpu_torch.obs import metrics, perf
from video_edge_ai_proxy_tpu_torch.obs import slo as tslo
from video_edge_ai_proxy_tpu_torch.obs.perf import PerfTracker, count_flops, resolve_peak_tflops
from video_edge_ai_proxy_tpu_torch.ops.preprocess import letterbox_params
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

PERF_FAMILIES = ("vep_compile_seconds", "vep_compile_programs_total",
                 "vep_compile_program_gflop", "vep_perf_device_ms",
                 "vep_perf_padded_slots_total", "vep_perf_batch_slots_total",
                 "vep_perf_bucket_occupancy_pct", "vep_perf_mfu_pct",
                 "vep_perf_achieved_tflops", "vep_perf_peak_tflops", "vep_perf_fps",
                 "vep_h2d_bytes", "vep_h2d_seconds", "vep_h2d_hidden_seconds")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# One sequence of notes: (advance s, kind, args, kwargs).
SEQUENCE = [
    (0.0, "compile", ("yolov8n", (1080, 1920), 16, 2.5), {"cost": {"flops": 2.2e11}}),
    (0.0, "compile", ("yolov8n", (720, 1280), 8, 1.25), {"cost": {"flops": 1.1e11}}),
    (0.1, "h2d", ("yolov8n", 16, 99532800 + 128, 0.004), {"hidden_s": 0.003}),
    (0.0, "batch", ("yolov8n", (1080, 1920), 16, 9.7, 16), {}),
    (0.2, "h2d", ("yolov8n", 16, 99532800 + 128, 0.005), {}),
    (0.0, "batch", ("yolov8n", (1080, 1920), 16, 10.3, 13), {}),
    (0.4, "batch", ("yolov8n", (720, 1280), 8, 6.1, 5), {}),
    (0.7, "batch", ("yolov8n", (1080, 1920), 16, 9.9, 16), {}),
    (3.0, "batch", ("vit_b16", (1080, 1920), 2, 4.0, 1), {}),
    (12.0, "batch", ("yolov8n", (1080, 1920), 16, 9.8, 16), {}),
]


def _feed(tracker, clock, step):
    dt, kind, args, kw = step
    clock.t += dt
    {"compile": tracker.note_compile, "batch": tracker.note_batch,
     "h2d": tracker.note_h2d}[kind](*args, **kw)


def test_perf_tracker_equals_jax_on_a_fake_clock():
    ours_clock, theirs_clock = FakeClock(), FakeClock()
    ours = PerfTracker(peak_tflops=989.4, registry=metrics.Registry(), clock=ours_clock)
    theirs = JPerfTracker(peak_tflops=989.4, registry=jmetrics.Registry(), clock=theirs_clock)
    for step in SEQUENCE:
        _feed(ours, ours_clock, step)
        _feed(theirs, theirs_clock, step)
        assert ours.fps() == theirs.fps()
        assert ours.snapshot() == theirs.snapshot()
    snap = ours.snapshot()
    mfu = {(b["model"], b["geometry"]): b["mfu_pct"] for b in snap["buckets"]}
    assert mfu[("yolov8n", "1080x1920")] > 0 and mfu[("vit_b16", "1080x1920")] is None
    assert snap["h2d_hidden_pct"] is not None
    for name in ("_m_occupancy", "_m_padded", "_m_slots", "_m_h2d_bytes", "_m_fps"):
        assert ([(lv, c.value) for lv, c in getattr(ours, name).children()]
                == [(lv, c.value) for lv, c in getattr(theirs, name).children()]), name
    # The MFU gauges: JAX's values; a program without FLOPs (vit_b16 here)
    # exports none (JAX exports a 0).
    for name in ("_m_mfu", "_m_tflops"):
        want = [(lv, c.value) for lv, c in getattr(theirs, name).children() if lv[0] != "vit_b16"]
        assert [(lv, c.value) for lv, c in getattr(ours, name).children()] == want, name


def test_families_are_jax_and_the_exposition_lints_clean():
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    ours = PerfTracker(peak_tflops=989.4, registry=reg, clock=FakeClock())
    JPerfTracker(registry=jreg)
    for step in SEQUENCE:
        _feed(ours, FakeClock(), step)
    fams = {f.name: (f.kind, f.labelnames) for f in reg.families()}
    jfams = {f.name: (f.kind, f.labelnames) for f in jreg.families()}
    for name in PERF_FAMILIES:
        assert fams[name] == jfams[name], name
    text = reg.render()
    assert metrics.lint_exposition(text) == []
    assert 'vep_perf_mfu_pct{model="yolov8n",bucket="16"}' in text
    assert "vep_perf_peak_tflops 989.4" in text


def test_rate_window_and_slo_verdicts_equal_jax():
    """One sequence of emits on a fake clock through both trackers; each
    tick samples the fps objective from its own tracker into its own
    package's SLO engine: the rates and the verdicts agree."""
    clock = FakeClock()
    ours = PerfTracker(registry=metrics.Registry(), clock=clock)
    theirs = JPerfTracker(registry=jmetrics.Registry(), clock=clock)
    kw = dict(latency_ms=40.0, target_fps=100.0, warmup_s=5.0)
    tengine = tslo.SLOEngine(tslo.default_slos(**kw), clock=clock, registry=metrics.Registry())
    jengine = jslo.SLOEngine(jslo.default_slos(**kw), clock=clock, registry=jmetrics.Registry())
    rng = np.random.default_rng(0)
    for tick in range(400):
        clock.t += 0.05
        frames = int(rng.integers(0, 16)) if tick < 200 else int(rng.integers(0, 3))
        if frames:
            ours.note_batch("yolov8n", (1080, 1920), 16, 9.0, frames)
            theirs.note_batch("yolov8n", (1080, 1920), 16, 9.0, frames)
        assert ours.fps() == theirs.fps()
        for engine, tracker in ((tengine, ours), (jengine, theirs)):
            good = tracker.fps() >= 100.0
            engine.get("aggregate_fps").record(good=float(good), bad=float(not good))
        if tick % 20 == 19:
            assert tengine.evaluate() == jengine.evaluate()
    assert tengine.evaluate()["slos"]["aggregate_fps"]["firing"] is True


@pytest.mark.parametrize("hw", [(96, 128), (270, 480)])
def test_flop_count_against_xla_and_analytic(hw):
    jmodel = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    n, thumb = 2, 32
    frames = np.zeros((n,) + hw + (3,), np.uint8)
    prev = np.zeros((n, thumb, thumb), np.float32)
    xla = cost_summary(jax.jit(jbuild_serving_step(
        jmodel, jregistry.get("tiny_yolov8"), quality_thumb=thumb)).lower(
            variables, frames, prev).compile())["flops"]

    model = load_flax(YOLOv8(tiny_yolov8_config(), torch.float32), variables).eval()
    step = build_serving_step(model, registry.get("tiny_yolov8"), quality_thumb=thumb)
    convs = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: convs.append(2 * o.numel() * m.weight[0].numel()))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    _, counted = count_flops(step, torch.from_numpy(frames), torch.from_numpy(prev))
    for h in hooks:
        h.remove()
    h, w = hw
    lb = letterbox_params(hw, 64)
    letterbox = 2 * n * lb.new_h * h * w * 3 + 2 * n * lb.new_h * lb.new_w * w * 3
    thumbs = 2 * n * thumb * h * w + 2 * n * thumb * thumb * w
    assert len(convs) == sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert counted == sum(convs) + letterbox + thumbs
    assert 1.0 <= counted / xla <= 1.25


def test_int_mm_flops_are_counted():
    rng = np.random.default_rng(1)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 8, 6, 6), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (16, 8, 3, 3), dtype=np.int8))
    _, counted = count_flops(int8_conv2d, xq, wq, 1, ((1, 1), (1, 1)))
    assert counted == 2 * (2 * 6 * 6) * (9 * 8) * 16     # the CPU's int32 mm
    a = torch.from_numpy(rng.integers(-127, 128, (32, 16), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (16, 8), dtype=np.int8))
    _, counted = count_flops(torch._int_mm, a, b)
    assert counted == 2 * 32 * 16 * 8


def test_peak_is_resolved_from_the_card(monkeypatch):
    assert resolve_peak_tflops(0.0, torch.device("cpu")) == 0.0
    assert resolve_peak_tflops(500.0, torch.device("cuda")) == 500.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert resolve_peak_tflops(0.0, torch.device("cuda")) == 989.4
    assert perf.PEAK_TFLOPS_BF16["NVIDIA H100 80GB HBM3"] != 197.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    with pytest.raises(ValueError, match="no bf16 peak known"):
        resolve_peak_tflops(0.0, torch.device("cuda"))


def _trace(n_ticks, hw=(32, 48), streams=2):
    frames = np.random.default_rng(0).integers(0, 256, (n_ticks, streams) + hw + (3,),
                                               dtype=np.uint8)
    return [[(f"cam{s}", frames[t, s], FrameMeta(packet=t, timestamp_ms=1)) for s in
             range(streams)] for t in range(n_ticks)]


def test_default_engine_exports_the_perf_families():
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prefetch=False),
                          device="cpu")
    eng.serve_lockstep(_trace(3))
    snap = eng.perf.snapshot()
    assert snap["peak_tflops"] == 0.0
    [rec] = snap["compiles"]
    assert (rec["model"], rec["geometry"], rec["bucket"], rec["programs"]) == (
        "tiny_yolov8", "32x48", 2, 1) and rec["flops"] > 0
    [cell] = snap["buckets"]
    assert cell["frames"] == 6 and cell["mfu_pct"] is None      # no peak on the CPU
    [h2d] = snap["h2d"]
    assert h2d["batches"] == 3 and h2d["bytes"] == 3 * (2 * 32 * 48 * 3 + 8 * 2)
    text = metrics.registry.render()
    for name in ("vep_compile_program_gflop", "vep_perf_device_ms", "vep_perf_fps",
                 "vep_perf_bucket_occupancy_pct", "vep_perf_batch_slots_total", "vep_h2d_bytes"):
        assert f'\n{name}' in text or f"{name}{{" in text, name
    assert 'vep_perf_mfu_pct{model="tiny_yolov8"' not in text


def test_the_fps_objective_reads_the_perf_tracker(monkeypatch):
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", slo_target_fps=50),
                          device="cpu")
    seen = []
    monkeypatch.setattr(eng.slo.get("aggregate_fps"), "record",
                        lambda good, bad: seen.append((good, bad)))
    for fps in (80.0, 10.0):
        monkeypatch.setattr(eng.perf, "fps", lambda v=fps: v)
        eng._slo_tick(["cam0"])
    assert seen == [(1.0, 0.0), (0.0, 1.0)]


_ENTRIES = [[32, 48, 1], [32, 48, 1, "", "classic"], [32, 48, 2, "", "s2d"]]


def test_variant_keys_equal_jax(tmp_path):
    """stem="s2d" with int8 weights: the step-cache keys, the prewarm
    manifest and prewarm_status of both engines, the classic-pinned entry
    skipped by both."""
    cfg = dict(model="tiny_yolov8", batch_buckets=(1, 2), tick_ms=5, prefetch=False,
               prewarm=[list(e) for e in _ENTRIES], aot_cache=True, stem="s2d",
               quantize="int8")
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    jbus = JMemoryFrameBus()
    try:
        jeng = JInferenceEngine(jbus, JEngineConfig(aot_cache_dir=str(tmp_path / "jax"), **cfg))
        eng = InferenceEngine(MemoryFrameBus(),
                              EngineConfig(aot_cache_dir=str(tmp_path / "torch"), **cfg),
                              device="cpu")
        jeng.start()
        try:
            eng.start()
            eng.stop()
        finally:
            jeng.stop()
    finally:
        jbus.close()
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    assert eng.prewarm_status() == jeng.prewarm_status() == {
        "required": 3, "done": 3, "complete": True, "aot_cache": True}
    assert list(eng._steps) == list(jeng._step_cache) == [
        ("tiny_yolov8", "s2d", (32, 48), 1), ("tiny_yolov8", "s2d", (32, 48), 2)]
    assert (aot_cache.load_manifest(str(tmp_path / "torch"))
            == jaot.load_manifest(str(tmp_path / "jax")))
    assert eng._model.cfg.stem == "s2d" and eng.residency["tiny_yolov8"][1] < \
        eng.residency["tiny_yolov8"][0]

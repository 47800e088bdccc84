"""The port's prewarm manifest and compiled-step cache against the JAX
package's.

- ``engine/aot_cache.py``: the manifest round-trip, the mismatch rule (a
  missing, unparseable or stale manifest gives None, never an
  exception), ``record_program``'s deduplication and replacement of a
  stale file, and ``prewarm_entries`` equal to the JAX function's on the
  same program lists;
- ``obs/perf.py``: ``note_compile``'s records equal to the JAX tracker's;
- the CPU engine (``tiny_yolov8``, ``device="cpu"``): ``prewarm_status()``
  equal to the JAX engine's for the same config and entries (a bucket the
  engine does not serve, a bad entry, a stem mismatch included), the
  step-cache hit and miss counters over a short trace, prewarm from the
  manifest, and no record of a program whose first call failed.

Exact equality throughout: this is host code.
"""

import json
import os

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.engine import aot_cache as jaot
from video_edge_ai_proxy_tpu.engine.runner import InferenceEngine as JInferenceEngine
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs.perf import PerfTracker as JPerfTracker
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import aot_cache
from video_edge_ai_proxy_tpu_torch.engine import runner
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.obs import metrics
from video_edge_ai_proxy_tpu_torch.obs.perf import PerfTracker
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

HW = (32, 48)


# -- the manifest -------------------------------------------------------------------------


def test_record_then_load_round_trip(tmp_path):
    d = str(tmp_path / "aot")
    aot_cache.record_program(d, model="tiny_yolov8", stem="classic", src_hw=HW, bucket=2)
    aot_cache.record_program(d, model=None, stem="classic", src_hw=(64, 64), bucket=1)
    aot_cache.record_program(d, model="tiny_yolov8", stem="s2d", src_hw=HW, bucket=4)
    assert aot_cache.load_manifest(d) == [
        {"model": "tiny_yolov8", "stem": "classic", "h": 32, "w": 48, "bucket": 2},
        {"model": None, "stem": "classic", "h": 64, "w": 64, "bucket": 1},
        {"model": "tiny_yolov8", "stem": "s2d", "h": 32, "w": 48, "bucket": 4},
    ]
    with open(aot_cache.manifest_path(d)) as fh:
        data = json.load(fh)
    assert set(data) == {"version", "stamp", "programs"}
    assert data["version"] == aot_cache.MANIFEST_VERSION == jaot.MANIFEST_VERSION
    assert aot_cache.MANIFEST_NAME == jaot.MANIFEST_NAME
    assert not os.path.exists(aot_cache.manifest_path(d) + ".tmp")


def _write(d, **over):
    data = {"version": aot_cache.MANIFEST_VERSION, "stamp": aot_cache._stamp(),
            "programs": [{"model": "m", "stem": "classic", "h": 8, "w": 8, "bucket": 1}]}
    data.update(over)
    os.makedirs(d, exist_ok=True)
    with open(aot_cache.manifest_path(d), "w") as fh:
        fh.write(json.dumps(data) if isinstance(data, dict) else data)


@pytest.mark.parametrize("case", ["missing", "unparseable", "not_a_mapping", "version",
                                  "stamp", "jaxlib_stamp", "programs_not_a_list"])
def test_unusable_manifest_gives_none(tmp_path, case):
    d = str(tmp_path / "aot")
    if case == "unparseable":
        os.makedirs(d)
        with open(aot_cache.manifest_path(d), "w") as fh:
            fh.write("{not json")
    elif case == "not_a_mapping":
        os.makedirs(d)
        with open(aot_cache.manifest_path(d), "w") as fh:
            fh.write("[1, 2]")
    elif case == "version":
        _write(d, version=aot_cache.MANIFEST_VERSION + 1)
    elif case == "stamp":
        _write(d, stamp="torch 0.0 cuda none another card")
    elif case == "jaxlib_stamp":
        # A manifest the JAX package wrote: its stamp is jaxlib's.
        jaot.record_program(d, model="m", stem="classic", src_hw=(8, 8), bucket=1)
    elif case == "programs_not_a_list":
        _write(d, programs={"h": 8})
    assert aot_cache.load_manifest(d) is None


def test_malformed_programs_are_filtered(tmp_path):
    d = str(tmp_path / "aot")
    _write(d, programs=[
        "not a dict",
        {"model": "m", "h": "x", "w": 8, "bucket": 1},     # unparseable
        {"model": "m", "h": 8, "w": 8, "bucket": 0},       # no bucket
        {"model": "m", "h": 8, "w": 8, "bucket": 2},
        {"model": "m", "stem": "classic", "h": 8, "w": 8, "bucket": 2},   # duplicate
    ])
    assert aot_cache.load_manifest(d) == [
        {"model": "m", "stem": "classic", "h": 8, "w": 8, "bucket": 2}]


@pytest.mark.parametrize("first,second", [
    ({"model": "tiny_yolov8", "stem": "classic"}, {"model": "tiny_yolov8", "stem": "classic"}),
    ({"model": None, "stem": "classic"}, {"model": "", "stem": ""}),
])
def test_record_program_deduplicates(tmp_path, first, second):
    d = str(tmp_path / "aot")
    aot_cache.record_program(d, src_hw=HW, bucket=2, **first)
    with open(aot_cache.manifest_path(d)) as fh:
        before = fh.read()
    aot_cache.record_program(d, src_hw=HW, bucket=2, **second)
    with open(aot_cache.manifest_path(d)) as fh:
        assert fh.read() == before
    assert len(aot_cache.load_manifest(d)) == 1


def test_record_replaces_a_stale_manifest(tmp_path):
    d = str(tmp_path / "aot")
    _write(d, stamp="another stamp")
    aot_cache.record_program(d, model="tiny_yolov8", stem="classic", src_hw=HW, bucket=1)
    assert aot_cache.load_manifest(d) == [
        {"model": "tiny_yolov8", "stem": "classic", "h": 32, "w": 48, "bucket": 1}]


# Single-card program lists, as the port records them (the JAX module's
# mesh key is not ported).
_PROGRAM_LISTS = [
    [],
    [{"model": "tiny_yolov8", "stem": "classic", "h": 32, "w": 48, "bucket": 2}],
    [{"model": None, "stem": "classic", "h": 1080, "w": 1920, "bucket": 16},
     {"model": "videomae_b_long", "stem": "classic", "h": 1080, "w": 1920, "bucket": 2},
     {"model": "yolov8n", "stem": "s2d", "h": 720, "w": 1280, "bucket": 8}],
]


@pytest.mark.parametrize("programs", _PROGRAM_LISTS)
def test_prewarm_entries_equal_jax(programs):
    assert aot_cache.prewarm_entries(programs) == jaot.prewarm_entries(programs)


@pytest.mark.parametrize("programs", _PROGRAM_LISTS)
def test_recorded_manifest_prewarms_like_jax(tmp_path, programs):
    """The same programs recorded by each package and read back by its own
    load_manifest give equal prewarm entries."""
    for prog in programs:
        for mod, d in ((aot_cache, "torch"), (jaot, "jax")):
            mod.record_program(str(tmp_path / d), model=prog["model"], stem=prog["stem"],
                               src_hw=(prog["h"], prog["w"]), bucket=prog["bucket"])
    ours = aot_cache.load_manifest(str(tmp_path / "torch")) or []
    theirs = jaot.load_manifest(str(tmp_path / "jax")) or []
    assert ours == theirs
    assert aot_cache.prewarm_entries(ours) == jaot.prewarm_entries(theirs)


# -- compile records -----------------------------------------------------------------------


def test_note_compile_records_equal_jax():
    notes = [("yolov8n", (1080, 1920), 16, 0.25), ("yolov8n", (1080, 1920), 16, 0.5),
             ("yolov8n", (720, 1280), 8, 0.125)]
    ours = PerfTracker(registry=metrics.Registry())
    theirs = JPerfTracker(registry=jmetrics.Registry())
    for i, note in enumerate(notes):
        ours.note_compile(*note, cost={"flops": 1e9 * (i + 1)})
        theirs.note_compile(*note, cost={"flops": 1e9 * (i + 1)})
    assert ours.compiles() == list(theirs._compiles.values())
    fam = ours._m_compile_programs
    assert fam.name == "vep_compile_programs_total"
    assert fam.labels("yolov8n", "1080x1920", "16").value == 2.0
    assert ours._m_compile_s.name == "vep_compile_seconds"
    assert ours._m_compile_s.labelnames == ("model", "geometry", "bucket")


def test_recorded_flops_round_trip_and_lookup(tmp_path):
    """A program's FLOP count rides with it in the manifest, so a member
    prewarming from it does not count it again; programs recorded without
    it (as the JAX manifest records all) have none."""
    d = str(tmp_path / "aot")
    aot_cache.record_program(d, model="yolov8n", stem="classic", src_hw=(1080, 1920),
                             bucket=8, flops=129281556480.0)
    aot_cache.record_program(d, model="mobilenet_v2", stem="classic", src_hw=(1080, 1920),
                             bucket=8)
    assert aot_cache.load_manifest(d) == [
        {"model": "yolov8n", "stem": "classic", "h": 1080, "w": 1920, "bucket": 8,
         "flops": 129281556480.0},
        {"model": "mobilenet_v2", "stem": "classic", "h": 1080, "w": 1920, "bucket": 8},
    ]
    lookup = dict(stem="classic", src_hw=(1080, 1920))
    assert aot_cache.program_flops(d, model="yolov8n", bucket=8, **lookup) == 129281556480.0
    assert aot_cache.program_flops(d, model="mobilenet_v2", bucket=8, **lookup) is None
    assert aot_cache.program_flops(d, model="yolov8n", bucket=4, **lookup) is None
    assert aot_cache.program_flops(str(tmp_path / "none"), model="yolov8n", bucket=8,
                                   **lookup) is None
    # The prewarm entries and the JAX reading of the same programs ignore it.
    progs = aot_cache.load_manifest(d)
    assert aot_cache.prewarm_entries(progs) == jaot.prewarm_entries(progs)


# -- the engine on the CPU -------------------------------------------------------------------

# A served program, a bucket the engine does not serve, a bad entry and a
# stem mismatch: all four count as done.
_ENTRIES = [[32, 48, 1], [32, 48, 3], ["x", 48, 1], [32, 48, 1, "", "s2d"]]


def _jax_cache_config():
    import jax

    return (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)


def _restore_jax_cache_config(saved):
    import jax

    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


@pytest.mark.parametrize("aot", [False, True])
def test_prewarm_status_equals_jax(tmp_path, aot):
    cfg = dict(model="tiny_yolov8", batch_buckets=(1, 2), tick_ms=5, prefetch=False,
               prewarm=[list(e) for e in _ENTRIES], aot_cache=aot)
    saved = _jax_cache_config()
    jbus = JMemoryFrameBus()
    try:
        jeng = JInferenceEngine(jbus, JEngineConfig(aot_cache_dir=str(tmp_path / "jax"), **cfg))
        eng = InferenceEngine(MemoryFrameBus(),
                              EngineConfig(aot_cache_dir=str(tmp_path / "torch"), **cfg),
                              device="cpu")
        assert eng.prewarm_status() == jeng.prewarm_status()
        jeng.start()
        try:
            eng.start()
            eng.stop()
            want = jeng.prewarm_status()
        finally:
            jeng.stop()
    finally:
        jbus.close()
        _restore_jax_cache_config(saved)
    assert eng.prewarm_status() == want
    assert want == {"required": 4, "done": 4, "complete": True, "aot_cache": aot}
    assert list(eng._steps) == [("tiny_yolov8", "classic", (32, 48), 1)]
    assert aot_cache.load_manifest(str(tmp_path / "torch")) == (
        [{"model": "tiny_yolov8", "stem": "classic", "h": 32, "w": 48, "bucket": 1}]
        if aot else None)


def _trace(n_ticks, streams=2, hw=HW, seed=0):
    frames = np.random.default_rng(seed).integers(0, 256, (n_ticks, streams) + hw + (3,),
                                                   dtype=np.uint8)
    return [[(f"cam{s}", frames[t, s], FrameMeta(packet=t)) for s in range(streams)]
            for t in range(n_ticks)]


def _cache_counts():
    return (metrics.registry.counter("vep_step_cache_misses_total").labels().value,
            metrics.registry.counter("vep_step_cache_hits_total").labels().value)


@pytest.mark.parametrize("prewarm", [[], [[32, 48, 2]]])
def test_step_cache_hits_and_misses_over_a_trace(prewarm):
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prefetch=False,
                                                         prewarm=prewarm), device="cpu")
    misses, hits = _cache_counts()
    eng.serve_lockstep(_trace(3))
    d_misses, d_hits = (a - b for a, b in zip(_cache_counts(), (misses, hits)))
    # One key: (tiny_yolov8, classic, 32x48, bucket 2). Its one miss is the
    # prewarm when there is one, else the first batch; every other lookup
    # of the key hits, the first batch after a prewarm included.
    assert d_misses == 1
    assert d_hits == 3 - (0 if prewarm else 1)
    assert list(eng._steps) == [("tiny_yolov8", "classic", (32, 48), 2)]
    assert eng.pipeline_stats().frames == 6


def test_a_second_engine_prewarms_from_the_manifest(tmp_path):
    d = str(tmp_path / "aot")
    first = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", prefetch=False, prewarm=[[32, 48, 2]], aot_cache=True,
        aot_cache_dir=d), device="cpu")
    fold = first.serve_lockstep(_trace(2))
    assert first.prewarm_status() == {"required": 1, "done": 1, "complete": True,
                                      "aot_cache": True}
    second = InferenceEngine(MemoryFrameBus(), EngineConfig(
        model="tiny_yolov8", prefetch=False, aot_cache=True, aot_cache_dir=d), device="cpu")
    second._model = first._model
    assert second.prewarm_status()["complete"] is False
    misses, hits = _cache_counts()
    assert second.serve_lockstep(_trace(2)) == fold
    assert second.prewarm_status() == {"required": 1, "done": 1, "complete": True,
                                       "aot_cache": True}
    assert _cache_counts() == (misses + 1, hits + 2)


def test_a_program_whose_first_call_failed_is_not_recorded(tmp_path):
    d = str(tmp_path / "aot")
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) == 1:
            raise RuntimeError("first call failed")
        return x

    def record():
        aot_cache.record_program(d, model="m", stem="classic", src_hw=HW, bucket=1)

    step = runner._record_after_first_success(flaky, record)
    with pytest.raises(RuntimeError):
        step(1)
    assert aot_cache.load_manifest(d) is None
    assert step(2) == 2 and step(3) == 3
    assert aot_cache.load_manifest(d) == [
        {"model": "m", "stem": "classic", "h": 32, "w": 48, "bucket": 1}]


def test_compile_for_skips_another_model_and_another_stem():
    # An entry pinned to another stem is skipped; another registry model
    # is a per-stream model, and compile_for builds its program as one more
    # key of the step cache, as the JAX engine's does.
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8"), device="cpu")
    eng.compile_for(HW, 1, stem="s2d")
    assert eng._steps == {}
    eng.compile_for(HW, 1, "tiny_yolov8", stem="classic")
    assert list(eng._steps) == [("tiny_yolov8", "classic", (32, 48), 1)]
    eng.compile_for(HW, 1, "tiny_vit")
    assert list(eng._steps) == [("tiny_yolov8", "classic", (32, 48), 1),
                                ("tiny_vit", "classic", (32, 48), 1)]

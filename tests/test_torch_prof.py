"""The port's triggered profiler (``obs/prof.py``) against the JAX
package's.

Both packages' ``Profiler`` run on the same fake monotonic and wall
clocks, a no-op sleep and a stub device tracer that writes
``<bundle>.trace.json`` into the bundle's ``device/`` (the name the
port's torch.profiler tracer writes) and advances the clocks as a real
bounded capture would. The scenarios mirror ``tests/test_prof.py``:

- the bundle and its manifest (:100): the same manifest (the bundle's
  absolute path apart), span and journal windows, snapshot; a bad
  duration, a busy flag, a failing tracer contained and counted;
- the trigger discipline (:162): one capture per SLO episode or
  escalation, the rate limit, the kill switch, busy suppression, the
  context in the manifest; the same decisions and metric counts;
- the retention ring (:225): the same evictions and retained bytes, the
  sequence resumed after a restart;
- the exposition (:329): the families render and lint clean.

On the port alone: a real ``torch.profiler`` capture of a CPU engine
(``device="cpu"``) whose trace ``find_device_trace`` finds, with the
engine's snapshot; the unbounded start/stop pair; a capture refused
while another torch.profiler session runs, the busy flag left clear;
the engine's ``_watch_tick`` polling the trigger with its SLO episodes
and rung. The REST and gRPC surfaces are held against the JAX
``Server`` in ``tests/test_torch_server.py``.
"""

import json
import os
import types

import pytest

from video_edge_ai_proxy_tpu.obs import journal as jjournal
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs import prof as jprof
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.obs import journal, metrics, prof
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

PACKAGES = {"jax": (jprof, jmetrics, jjournal), "port": (prof, metrics, journal)}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class StubTracer:
    """Writes a Chrome trace named as the torch tracer names it (plus
    optional filler bytes) and advances the fake clocks by ``ms``."""

    def __init__(self, clocks=(), filler_bytes=0, fail=False):
        self.clocks = clocks
        self.filler_bytes = filler_bytes
        self.fail = fail
        self.calls = 0

    def __call__(self, log_dir, ms):
        self.calls += 1
        for clk in self.clocks:
            clk.advance(ms / 1000.0)
        if self.fail:
            raise OSError("trace backend exploded")
        name = os.path.basename(os.path.dirname(log_dir))
        with open(os.path.join(log_dir, f"{name}.trace.json"), "w") as f:
            json.dump({"traceEvents": [{"ph": "X", "name": "k", "cat": "kernel", "pid": 0,
                                        "tid": 7, "ts": 1.0, "dur": 2.0}]}, f)
        if self.filler_bytes:
            with open(os.path.join(log_dir, "filler.bin"), "wb") as f:
                f.write(b"\0" * self.filler_bytes)


class Spans:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


def make(pmod, mmod, tmp, **kw):
    clk = kw.pop("clock", Clock())
    wall = kw.pop("wall_clock", Clock(1.7e9))
    stub = kw.pop("device_tracer", None) or StubTracer(clocks=(clk, wall),
                                                        **kw.pop("stub", {}))
    reg = kw.pop("registry", None) or mmod.Registry()
    p = pmod.Profiler(str(tmp), clock=clk, wall_clock=wall, sleep=lambda s: None,
                      device_tracer=stub, registry=reg, async_triggers=False, **kw)
    return p, clk, wall, stub, reg


def both(tmp_path, fn):
    """``fn`` on each package, each in a ring directory of its own whose
    path has the same length (a manifest holds its path: the bytes the
    ring counts must agree)."""
    return {tag: fn(*mods, tmp_path / tag[0]) for tag, mods in PACKAGES.items()}


def equal(results):
    assert results["port"] == results["jax"]
    return results["port"]


def stable(manifest):
    """A manifest without its absolute path (each package has its own
    ring directory)."""
    return {k: v for k, v in manifest.items() if k != "path"}


def counts(reg):
    return {name: [(s["labels"], s.get("value", s.get("count"))) for s in v["samples"]]
            for name, v in reg.snapshot().items()}


# -- bundles ----------------------------------------------------------------------------------


def test_bundle_contents_and_manifest_equal_jax(tmp_path):
    def run(pmod, mmod, jmod, tmp):
        wall = Clock(1.7e9)
        spans = Spans([{"stream": "cam1", "stage": "device", "frame": 1, "ts": wall.t + 0.05,
                        "dur_ms": 8.0},
                       {"stream": "cam1", "stage": "emit", "frame": 0, "ts": wall.t - 50.0}])
        j = jmod.DecisionJournal(16, clock=wall, registry=mmod.Registry())
        j.record("slo", "episode_open", subject=("slo", "lat"))
        p, clk, wall, stub, reg = make(pmod, mmod, tmp, wall_clock=wall, tracer=spans,
                                       journal=j, snapshot_fn=lambda: {"fps": 42.0})
        wall.advance(0.01)
        man = p.capture(100, context={"slo_episode": 3})
        j.record("ladder", "escalate", subject=("ladder", "engine"))
        files = {}
        for name in (pmod.SPANS, pmod.JOURNAL, pmod.SNAPSHOT, pmod.MANIFEST):
            with open(os.path.join(man["path"], name)) as f:
                files[name] = json.load(f)
        files[pmod.MANIFEST].pop("path")
        for ev in files[pmod.JOURNAL]["events"]:
            ev.pop("ts")
        snap = p.snapshot()
        snap.pop("dir")
        snap["captures"] = [stable(m) for m in snap["captures"]]
        return {"manifest": stable(man), "files": files, "snapshot": snap,
                "found": pmod.find_device_trace(man["path"]), "metrics": counts(reg)}
    out = equal(both(tmp_path, run))
    man = out["manifest"]
    assert man["error"] is None and man["slo_episode"] == 3 and man["span_events"] == 1
    assert man["device_trace"] == out["found"] == f"device/{man['bundle']}.trace.json"
    assert out["files"]["spans.json"]["events"][0]["stage"] == "device"
    assert out["files"]["snapshot.json"] == {"fps": 42.0}
    assert out["snapshot"]["bundles"] == 1 and out["snapshot"]["busy"] is None


def test_bad_duration_busy_and_a_failing_tracer_equal_jax(tmp_path):
    def run(pmod, mmod, jmod, tmp):
        p, clk, wall, stub, reg = make(pmod, mmod, tmp, max_ms=1000)
        errors = []
        for ms in (0, 1001):
            with pytest.raises(ValueError) as err:
                p.capture(ms)
            errors.append(str(err.value))
        p._acquire("capture")
        with pytest.raises(RuntimeError) as err:
            p.capture(10)
        errors.append(str(err.value))
        p._release()
        stub.fail = True
        failed = stable(p.capture(50))
        stub.fail = False
        after = stable(p.capture(50))
        return errors, failed, after, p.errors, counts(reg)
    errors, failed, after, n_errors, _ = equal(both(tmp_path, run))
    assert "trace backend exploded" in failed["error"] and failed["device_trace"] is None
    assert after["error"] is None and n_errors == 1


# -- triggers ---------------------------------------------------------------------------------------


def _trigger_script(pmod, mmod, jmod, tmp):
    p, clk, _, stub, reg = make(pmod, mmod, tmp, trigger_min_interval_s=5.0)
    fired = [p.poll(episodes=1)]
    for _ in range(3):
        clk.advance(10.0)
        fired.append(p.poll(episodes=1))
    fired.append(p.poll(episodes=2, context={"slo_episode": 2, "rung": "shed"}))
    clk.advance(1.0)
    fired += [p.poll(rung=1), p.poll(rung=2)]
    clk.advance(10.0)
    fired += [p.poll(rung=2), p.poll(rung=0), p.poll(rung=1)]
    p._acquire("manual")
    fired.append(p.poll(episodes=3))
    p._release()
    return {"fired": fired, "calls": stub.calls,
            "manifests": [stable(m) for m in p.captures()], "metrics": counts(reg)}


def test_trigger_discipline_equal_jax(tmp_path):
    out = equal(both(tmp_path, _trigger_script))
    assert out["fired"][:5] == ["slo_episode", None, None, None, "slo_episode"]
    assert out["calls"] == len([f for f in out["fired"] if f])
    assert out["manifests"][1]["context"]["reason"] == "slo_episode"
    assert out["manifests"][1]["context"]["rung"] == "shed"


def test_trigger_kill_switch_equal_jax(tmp_path):
    def run(pmod, mmod, jmod, tmp):
        p, _, _, stub, _ = make(pmod, mmod, tmp, trigger=False)
        return [p.poll(episodes=1), p.poll(rung=1)], stub.calls
    assert equal(both(tmp_path, run)) == ([None, None], 0)


# -- retention ---------------------------------------------------------------------------------


def test_retention_ring_equal_jax(tmp_path):
    def run(pmod, mmod, jmod, tmp):
        clk, wall = Clock(), Clock(1.7e9)
        p, _, _, _, reg = make(pmod, mmod, tmp, clock=clk, wall_clock=wall,
                               device_tracer=StubTracer(clocks=(clk, wall), filler_bytes=4096),
                               retention_bytes=10_000, trigger_min_interval_s=0.0)
        names = [p.capture(10)["bundle"] for _ in range(4)]
        kept = [os.path.basename(b) for b in p._bundles()]
        first = (names, kept, p._retained_bytes(), counts(reg))
        p2 = make(pmod, mmod, tmp)[0]
        return first, p2.capture(10)["bundle"]
    (names, kept, retained, metric), resumed = equal(both(tmp_path, run))
    assert retained <= 10_000 and names[-1] in kept and names[0] not in kept
    assert resumed.startswith("00000004")


def test_prof_families_lint_clean_equal_jax(tmp_path):
    def run(pmod, mmod, jmod, tmp):
        p, clk, _, _, reg = make(pmod, mmod, tmp, trigger_min_interval_s=5.0)
        p.capture(10)
        p.poll(episodes=1)
        p.poll(rung=1)
        text = reg.render()
        return [line for line in text.splitlines() if "wall_ms" not in line], \
            mmod.lint_exposition(text)
    lines, problems = equal(both(tmp_path, run))
    assert problems == [] and any("vep_prof_suppressed_total" in ln for ln in lines)


# -- the port on the CPU: a real torch.profiler capture ----------------------------------------


@pytest.fixture()
def engine(tmp_path):
    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2),
                                            prof_dir=str(tmp_path / "ring")), device="cpu")
    yield eng
    bus.close()


def test_a_real_capture_of_a_cpu_engine(engine):
    import torch

    p = engine.prof
    assert p is not None and p._cuda is False
    p._sleep = lambda s: torch.ones(64, 64) @ torch.ones(64, 64)   # some CPU work
    man = p.capture(50, context={"via": "test"})
    assert man["error"] is None, man["error"]
    assert man["device_trace"] == f"device/{man['bundle']}.trace.json"
    assert prof.find_device_trace(man["path"]) == man["device_trace"]
    with open(os.path.join(man["path"], man["device_trace"])) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    with open(os.path.join(man["path"], prof.SNAPSHOT)) as f:
        snap = json.load(f)
    assert snap["rung"] == "normal" and "slo" in snap
    assert snap["perf"] == {"peak_tflops": 0.0, "fps": 0.0, "compiles": [], "buckets": [],
                            "h2d": [], "h2d_hidden_pct": None}
    assert p.snapshot()["bundles"] == 1 and p.errors == 0


def test_start_stop_and_a_foreign_session_refused(engine, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    engine.start_profile(str(tmp_path / "manual"))
    with pytest.raises(RuntimeError):
        engine.prof.capture(10)                 # the manual trace holds the flag
    with pytest.raises(RuntimeError):
        engine.start_profile(str(tmp_path / "again"))
    engine.stop_profile()
    assert os.path.isfile(tmp_path / "manual" / "manual.trace.json")
    with pytest.raises(RuntimeError):
        engine.stop_profile()
    # Another session owns Kineto: the capture is refused, recorded as its
    # error and counted; the flag is clear for the next capture.
    with profile(activities=[ProfilerActivity.CPU]):
        man = engine.prof.capture(10)
        with pytest.raises(RuntimeError):
            engine.start_profile(str(tmp_path / "nested"))
    assert "another torch.profiler session is active" in man["error"]
    assert engine.prof.errors == 1 and engine.prof.snapshot()["busy"] is None
    assert engine.prof.capture(10)["error"] is None


def test_disabled_profiling_refuses_the_pair(tmp_path):
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prof=False),
                          device="cpu")
    assert eng.prof is None
    for call in (lambda: eng.start_profile(str(tmp_path)), eng.stop_profile):
        with pytest.raises(RuntimeError):
            call()


def test_the_engine_polls_the_trigger_with_its_episodes_and_rung(engine):
    calls = []
    engine.prof = types.SimpleNamespace(poll=lambda **kw: calls.append(kw))
    engine.slo = None             # keeps the episode count set here
    engine._slo_episodes = 2
    engine._watch_tick(["cam0"])
    engine.ladder._rung = 2
    engine._watch_tick([])
    assert [c["episodes"] for c in calls] == [2, 2] and [c["rung"] for c in calls] == [0, 2]
    assert calls[1]["context"] == {"slo_episode": 2, "slo_burning": False,
                                   "rung": "bucket_downshift"}
    # drain backpressure and a recompile storm are watchdog episodes
    engine._bp_depth = 2
    for _ in range(4):
        engine._m_cache_miss.inc()
        engine._watch_tick([])
    assert set(engine.watchdog.active()) >= {"drain_backpressure", "recompile_storm"}

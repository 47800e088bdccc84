"""The port's watchdog (``obs/watch.py``), lineage tracer (``obs/spans.py``),
metrics linter and the hooks that feed them, held against the JAX
package's.

- ``SpanRecorder``: the same sampled packets, ring bounds and events;
  ``stage_breakdown`` equal on the same spans; ``to_chrome_trace`` equal
  and valid by both packages' validators; ``trace_id_of``
  (``tests/test_obs.py:114``).
- ``Watchdog``: once-per-episode logging, both directions, the same
  episodes, snapshots (times apart) and journal events
  (``tests/test_obs.py:172``); the breaker stuck open and the canary
  (``tests/test_torch_canary.py``) as its sources.
- The stages on the frame path: the ingest worker's ``publish`` spans
  and the collector's ``collect`` spans equal the JAX worker's and
  collector's on one sequence, with ``VEP_OBS_TRACE`` in the worker's
  environment.
- ``set_const_labels`` and ``lint_exposition`` on both registries: the
  same exposition, linted clean by both linters.
"""

import logging
import time

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.bus.interface import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu.ingest import IngestWorker as JIngestWorker
from video_edge_ai_proxy_tpu.ingest import WorkerConfig as JWorkerConfig
from video_edge_ai_proxy_tpu.obs import journal as jjournal
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs import spans as jspans
from video_edge_ai_proxy_tpu.obs import watch as jwatch
from video_edge_ai_proxy_tpu.resilience import breaker as jbreaker
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import collector
from video_edge_ai_proxy_tpu_torch.ingest import IngestWorker, WorkerConfig
from video_edge_ai_proxy_tpu_torch.obs import journal, metrics, spans, watch
from video_edge_ai_proxy_tpu_torch.resilience import breaker


class Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def both(fn):
    return {"jax": fn(jspans, jwatch, jjournal, jmetrics, jbreaker),
            "port": fn(spans, watch, journal, metrics, breaker)}


def equal(results):
    assert results["port"] == results["jax"]
    return results["port"]


# -- spans ------------------------------------------------------------------------------------


@pytest.mark.parametrize("every", [1, 4, 16])
def test_sampling_and_ring_equal_jax(every):
    def run(smod, *_):
        rec = smod.SpanRecorder(sample_every=every, enabled=True, ring=4)
        picked = [fid for fid in range(40) if rec.sampled(fid)]
        for i in picked:
            rec.record("cam1", "collect", i, ts=float(i), pub_ms=i * 1000.0 - 5.0)
        rec.configure(ring=2)
        kept = rec.events("cam1")
        rec.configure(enabled=False)
        return picked, kept, rec.events(limit=1), rec.streams(), rec.sampled(0)
    picked, kept, _, streams, off = equal(both(run))
    assert picked == list(range(0, 40, every)) and len(kept) == 2 and off is False


def _lineages(rec):
    """Three lineages: one complete (publish stamp on the collect span),
    one with a publish span only and a drop, one partial."""
    t0 = 1000.0
    rec.record("cam1", "collect", 7, ts=t0 + 0.005, pub_ms=t0 * 1000.0, trace_id=11)
    rec.record("cam1", "submit", 7, ts=t0 + 0.007, bucket=2)
    rec.record("cam1", "device", 7, ts=t0 + 0.011, dur_ms=4.0, bucket=2)
    rec.record("cam1", "emit", 7, ts=t0 + 0.0115)
    rec.record("cam2", "publish", 3, ts=t0)
    rec.record("cam2", "collect", 3, ts=t0 + 0.02)
    rec.record("cam2", "dropped", 3, ts=t0 + 0.03, reason="stale_shed")
    rec.record("cam3", "device", 5, ts=t0 + 0.04, dur_ms=2.5)


def test_stage_breakdown_and_chrome_trace_equal_jax():
    def run(smod, *_):
        rec = smod.SpanRecorder(enabled=True, sample_every=1)
        _lineages(rec)
        evs = rec.events()
        chrome = smod.to_chrome_trace(evs)
        return evs, smod.stage_breakdown(evs), chrome, smod.validate_chrome_trace(chrome)
    evs, legs, chrome, problems = equal(both(run))
    assert problems == [] and jspans.validate_chrome_trace(chrome) == []
    assert legs["total"]["count"] == 1 and legs["total"]["avg"] == pytest.approx(11.5, abs=0.01)
    assert legs["ingest_bus"]["count"] == 2 and legs["device"]["count"] == 2
    assert legs["drops"] == {"count": 1, "by_reason": {"stale_shed": 1}}
    bad = {"traceEvents": [{"ph": "X"}]}
    assert spans.validate_chrome_trace(bad) == jspans.validate_chrome_trace(bad) != []
    assert spans.validate_chrome_trace([]) == jspans.validate_chrome_trace([]) != []


@pytest.mark.parametrize("stamped", [0, 12345])
def test_trace_id_of_equals_jax(stamped):
    meta, jmeta = (FrameMeta(packet=9, trace_id=stamped), JFrameMeta(packet=9, trace_id=stamped))
    assert spans.trace_id_of(meta, "cam1") == jspans.trace_id_of(jmeta, "cam1")
    assert spans.trace_id_of(meta, "cam1") == (stamped or spans.trace_id_for("cam1", 9))


# -- the watchdog ----------------------------------------------------------------------------------


def _snap(wd):
    """The snapshot without its wall times."""
    s = wd.snapshot()
    return {"active": {k: {f: v[f] for f in ("peak", "threshold", "direction", "detail", "seq")}
                       for k, v in s["active"].items()},
            "episodes": s["episodes"],
            "last": {k: {f: v[f] for f in ("peak", "threshold", "direction")}
                     for k, v in s["last"].items()}}


def test_watchdog_once_per_episode_equal_jax(caplog):
    def run(smod, wmod, jmod, mmod, _):
        j = jmod.DecisionJournal(64, registry=mmod.Registry())
        wd = wmod.Watchdog(journal=j)
        with caplog.at_level(logging.INFO):
            caplog.clear()
            seen = [wd.check("depth", v, above=2) for v in (5, 9, 1, 7)]
            seen += [wd.check("occupancy", v, below=25.0) for v in (10.0, 50.0)]
            levels = [r.levelno for r in caplog.records if "watch:" in r.getMessage()]
        out = {"seen": seen, "levels": levels, "snap": _snap(wd),
               "events": [(e["actor"], e["action"], e["subject"], e["cause"],
                           {k: v for k, v in e["trigger"].items() if k != "duration_s"})
                          for e in j.events()]}
        wd.reset()
        out["reset"] = wd.snapshot()
        return out
    out = equal(both(run))
    assert out["seen"] == [True, True, False, True, True, False]
    assert out["levels"].count(logging.WARNING) == 3 and out["snap"]["episodes"]["depth"] == 2
    assert out["snap"]["active"]["depth"]["peak"] == 7


def test_watchdog_validates_its_direction():
    for wmod in (watch, jwatch):
        wd = wmod.Watchdog()
        for kwargs in ({}, {"above": 1.0, "below": 2.0}):
            with pytest.raises(ValueError):
                wd.check("x", 1.0, **kwargs)


def test_each_open_spell_past_the_bound_is_one_episode_equal_jax():
    """Each spell of a breaker open longer than ``max_open_s`` is one
    watchdog episode, closed when a call is let through again."""
    def run(smod, wmod, jmod, mmod, bmod):
        clk = Clock()
        wd = wmod.Watchdog()
        br = bmod.CircuitBreaker("uplink_test", failure_threshold=1, recovery_timeout_s=30.0,
                                 max_open_s=10.0, clock=clk, watchdog=wd)
        br.record_failure()
        allowed = []
        for _ in range(5):
            allowed.append(br.allow())
            clk.advance(20.0)
            if br.state == "half_open":
                br.record_failure()
        br.record_success()
        allowed.append(br.allow())
        return allowed, _snap(wd), br.snapshot()
    allowed, snap, _ = equal(both(run))
    assert snap["episodes"] == {"breaker_uplink_test_open": 2} and allowed[-1]


# -- the frame path's spans ----------------------------------------------------------------------


def _traced(smod):
    smod.tracer.configure(enabled=True, sample_every=4)
    smod.tracer.clear()


def _untraced(smod):
    smod.tracer.configure(enabled=False, sample_every=16)
    smod.tracer.clear()


def _stable_spans(events):
    return sorted(((e["stream"], e["stage"], e["frame"],
                    {k: v for k, v in e.items() if k not in ("ts", "pub_ms", "stream", "stage",
                                                             "frame")})
                   for e in events), key=repr)


def test_worker_publish_and_collector_collect_spans_equal_jax(monkeypatch):
    monkeypatch.setenv("VEP_OBS_TRACE", "1")
    monkeypatch.setenv("VEP_OBS_SAMPLE_EVERY", "4")
    url = "test://pattern?w=64&h=48&fps=30&gop=5&pace=0&frames=13"
    got = {}
    for tag, smod, bus_t, worker_t, cfg_t, col_t in (
            ("port", spans, MemoryFrameBus, IngestWorker, WorkerConfig, collector.Collector),
            ("jax", jspans, JMemoryFrameBus, JIngestWorker, JWorkerConfig, jcollector.Collector)):
        _untraced(smod)
        bus = bus_t()
        try:
            bus.touch_query("cam1")
            worker_t(cfg_t(rtsp_endpoint=url, device_id="cam1", bus_backend="memory",
                           max_frames=13), bus=bus).run()
            assert smod.tracer.enabled and smod.tracer.sample_every == 4
            published = smod.tracer.events()
            smod.tracer.clear()
            # The collector reads the newest frame (packet 12, sampled)
            # and stamps its collect span with the publish stamp.
            col = col_t(bus, buckets=(1,))
            assert col.collect()
            got[tag] = (published, smod.tracer.events())
        finally:
            _untraced(smod)
            bus.close()
    (pub, col), (jpub, jcol) = got["port"], got["jax"]
    assert _stable_spans(pub) == _stable_spans(jpub)
    assert [e["frame"] for e in pub] == [0, 4, 8, 12]
    assert _stable_spans(col) == _stable_spans(jcol)
    assert [(e["stage"], e["frame"]) for e in col] == [("collect", 12)]
    assert col[0]["pub_ms"] == pytest.approx(jcol[0]["pub_ms"], abs=60_000)


def test_engine_spans_close_every_sampled_lineage():
    """The engine's submit, device and emit spans, and a ``dropped`` span
    for the frames its shedding drops: every sampled lineage ends."""
    import torch

    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2, 4),
                                            prefetch=False), device="cpu")
    eng._model = eng._spec.init_params(torch.Generator().manual_seed(0), device="cpu",
                                       dtype=torch.float32)
    _traced(spans)
    try:
        now = int(time.time() * 1000)
        ticks = [[(f"cam{i}", np.full((32, 32, 3), 40 * i, np.uint8),
                   FrameMeta(width=32, height=32, channels=3, packet=p, timestamp_ms=now))
                  for i in range(3)] for p in (0, 4)]
        eng.serve_lockstep(ticks)
        stale = eng._collector.collect(device_ids=["cam0"])
        bus.publish("cam0", np.zeros((32, 32, 3), np.uint8),
                    FrameMeta(width=32, height=32, channels=3, packet=8, timestamp_ms=now - 9000))
        stale = eng._collector.collect(device_ids=["cam0"])
        assert eng._shed_stale_groups(stale) == []
        events = spans.tracer.events()
    finally:
        _untraced(spans)
        bus.close()
    by = {}
    for e in events:
        by.setdefault((e["stream"], e["frame"]), []).append(e["stage"])
    assert by[("cam1", 4)] == ["collect", "submit", "device", "emit"]
    assert by[("cam0", 8)] == ["collect", "dropped"]
    legs = spans.stage_breakdown(events)
    assert legs["device"]["count"] == 6 and legs["drops"]["by_reason"] == {"stale_shed": 1}


# -- the exposition ---------------------------------------------------------------------------


def test_const_labels_and_lint_equal_jax():
    def run(smod, wmod, jmod, mmod, _):
        reg = mmod.Registry()
        reg.counter("t_events_total", "events", ("stream",)).labels('cam"1').inc(3)
        reg.gauge("t_depth", "depth").labels().set(2)
        reg.histogram("t_latency_ms", "latency", ("instance",)).labels("own").observe(5.0)
        jmod.DecisionJournal(16, registry=reg).record("ladder", "escalate")
        before = reg.render()
        reg.set_const_labels(instance="edge-0", zone="a")
        text = reg.render()
        return before, text, reg.const_labels, mmod.lint_exposition(text)
    before, text, const, problems = equal(both(run))
    assert problems == [] and jmetrics.lint_exposition(before) == []
    assert const == {"instance": "edge-0", "zone": "a"}
    assert 't_latency_ms_count{zone="a",instance="own"} 1' in text
    bad = "\n".join(["# TYPE a counter", "a 1", "# TYPE b gauge", "b 1", "a 2", "b x"])
    assert metrics.lint_exposition(bad) == jmetrics.lint_exposition(bad) != []

"""The device-memory plane (``obs/hbm.py``) and the ladder's HBM pressure
against the JAX package's, on one input sequence and a fake clock; the
engine's pools against their own bytes; ``/api/v1/hbm``.

Host arithmetic on the same inputs: every snapshot, verdict and rung must
be equal.
"""

import asyncio

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.obs import hbm as jhbm
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs.journal import DecisionJournal as JDecisionJournal
from video_edge_ai_proxy_tpu.resilience.ladder import DegradationLadder as JDegradationLadder
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.obs import hbm, metrics
from video_edge_ai_proxy_tpu_torch.obs.journal import DecisionJournal
from video_edge_ai_proxy_tpu_torch.resilience.ladder import DegradationLadder
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


class FakeClock:
    def __init__(self, t: float = 500.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _pool_script():
    """Pool byte levels over 60 evaluations: a steady pool, a ramp toward
    the budget, a sharded pool and one whose callable fails midway."""
    def steady(i):
        return 1 << 20

    def ramp(i):
        return (i * 7) << 20

    def sharded(i):
        return {"0": 1000 + i, "1": 2000}

    def flaky(i):
        if 20 <= i < 25:
            raise RuntimeError("pool gone")
        return 4096
    return {"steady": steady, "ramp": ramp, "sharded": sharded, "flaky": flaky}


def _tracker(mod, reg, clock, step):
    t = mod.HbmTracker(budget_bytes=512 << 20, fast_window_s=5.0, slow_window_s=30.0,
                       eval_interval_s=1.0, pressure_horizon_s=20.0, clock=clock, registry=reg)
    for name, fn in _pool_script().items():
        t.register_pool(name, lambda fn=fn: fn(step[0]))
    return t


def test_hbm_tracker_equals_jax():
    clock, step = FakeClock(), [0]
    ours = _tracker(hbm, metrics.Registry(), clock, step)
    theirs = _tracker(jhbm, jmetrics.Registry(), clock, step)
    programs = {3: ("yolov8n", (1080, 1920), 16, {"argument_bytes": 99532800,
                                                  "output_bytes": 8000, "temp_bytes": 1 << 30}),
                9: ("yolov8n", (1080, 1920), 8, {"argument_bytes": 49766400,
                                                 "output_bytes": 4000, "temp_bytes": 1 << 29}),
                12: ("yolov8n", (1080, 1920), 16, {"argument_bytes": 99532800,
                                                   "output_bytes": 8000, "temp_bytes": 1 << 28})}
    pressures = []
    for i in range(60):
        step[0] = i
        clock.t += 0.5
        if i in programs:
            model, hw, bucket, summary = programs[i]
            for t in (ours, theirs):
                t.note_program(model, hw, bucket, summary, stem="s2d")
        assert ours.evaluate() == theirs.evaluate()
        assert ours.pressure() == theirs.pressure()
        pressures.append(ours.pressure())
        if i % 10 == 0:
            assert ours.evaluate(force=True) == theirs.evaluate(force=True)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.programs() == theirs.programs()
    assert ours.pools() == theirs.pools()
    assert any(pressures) and not all(pressures)
    assert hbm.DEFAULT_SYNTHETIC_BUDGET_BYTES == jhbm.DEFAULT_SYNTHETIC_BUDGET_BYTES
    # The families are JAX's.
    reg, jreg = metrics.Registry(), jmetrics.Registry()
    hbm.HbmTracker(registry=reg)
    jhbm.HbmTracker(registry=jreg)
    assert ({f.name: (f.kind, f.labelnames) for f in reg.families()}
            == {f.name: (f.kind, f.labelnames) for f in jreg.families()})


def test_hbm_tracker_refuses_bad_windows_and_keeps_a_synthetic_budget():
    for mod in (hbm, jhbm):
        with pytest.raises(ValueError):
            mod.HbmTracker(fast_window_s=10.0, slow_window_s=5.0, registry=None)
        t = mod.HbmTracker(registry=(metrics.Registry() if mod is hbm else jmetrics.Registry()))
        t.set_budget(0)
        assert (t.budget_bytes, t.budget_measured) == (4 << 30, False)
        t.set_budget(80 << 30)
        assert (t.budget_bytes, t.budget_measured) == (80 << 30, True)


def _ladders():
    clock = FakeClock(0.0)
    ours = DegradationLadder(escalate_after_s=0.5, recover_after_s=2.0, clock=clock,
                             journal=DecisionJournal(64))
    theirs = JDegradationLadder(escalate_after_s=0.5, recover_after_s=2.0, clock=clock,
                                journal=JDecisionJournal(64))
    return clock, ours, theirs


def test_ladder_escalates_on_hbm_pressure_as_jax():
    clock, ours, theirs = _ladders()
    rungs = []
    for i in range(80):
        clock.t += 0.25
        kw = dict(queue_depth=0, tick_lag_s=0.001, tick_budget_s=0.01,
                  slo_burning=False, hbm_pressure=10 <= i < 30)
        got, want = ours.observe(**kw), theirs.observe(**kw)
        assert got == want
        assert ours._pressure_detail == theirs._pressure_detail
        rungs.append(got)
    assert "admission_pause" in rungs and rungs[-1] == "normal"
    esc = ours.journal.events(actor="ladder", action="escalate")
    assert esc and all(e["trigger"]["hbm_pressure"] is True for e in esc)


def _trace(n_ticks, hw=(32, 48), streams=3):
    frames = np.random.default_rng(0).integers(0, 256, (n_ticks, streams) + hw + (3,),
                                               dtype=np.uint8)
    return [[(f"cam{s}", frames[t, s], FrameMeta(packet=t)) for s in range(streams)]
            for t in range(n_ticks)]


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_pool_bytes_are_the_pools_own(prefetch):
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", prefetch=prefetch,
                                                         hbm=True), device="cpu")
    assert eng.hbm.budget_bytes == hbm.DEFAULT_SYNTHETIC_BUDGET_BYTES
    eng.serve_lockstep(_trace(3))
    pools = eng.hbm.pools()
    assert set(pools["pools"]) == {"thumbs", "track_state", "prefetch", "collector_host"}
    own = {"thumbs": int(eng._thumbs._pool.nbytes),
           "track_state": 0,
           "prefetch": 0,             # every placement was dispatched
           "collector_host": sum(b.nbytes for slot in eng._collector._pool.values()
                                 for b in slot["bufs"])}
    assert {k: r["bytes"] for k, r in pools["pools"].items()} == own
    assert pools["total"] == sum(own.values()) > 0
    snap = eng.hbm.snapshot()
    assert snap["used_bytes"] == pools["total"] and snap["programs"] == {}   # no graph on the CPU


def test_engine_without_hbm_has_no_plane():
    eng = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8"), device="cpu")
    assert eng.hbm is None


class _Engine:
    def __init__(self, plane):
        self.hbm = plane


def _get(app, path):
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        async with TestClient(TestServer(app)) as client:
            resp = await client.get(path)
            return resp.status, await resp.json()
    return asyncio.run(go())


def test_hbm_route():
    from video_edge_ai_proxy_tpu_torch.serve.rest_api import build_app

    assert _get(build_app(None, None, engine=None), "/api/v1/hbm")[0] == 400
    status, body = _get(build_app(None, None, engine=_Engine(None)), "/api/v1/hbm")
    assert status == 400 and "disabled" in body["message"]
    plane = hbm.HbmTracker(registry=metrics.Registry())
    plane.register_pool("thumbs", lambda: 4096)
    plane.note_program("yolov8n", (1080, 1920), 16,
                       {"argument_bytes": 10, "output_bytes": 20, "temp_bytes": 30})
    status, body = _get(build_app(None, None, engine=_Engine(plane)), "/api/v1/hbm")
    jplane = jhbm.HbmTracker(registry=jmetrics.Registry())
    assert status == 200 and set(body) == set(jplane.snapshot())
    assert body["pools"]["total"] == 4096
    assert body["programs"]["yolov8n|classic|1080x1920|16|-"]["workspace_bytes"] == 60

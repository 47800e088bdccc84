"""The port's decision journal (``obs/journal.py``) and its hooks in the
ladder, the SLO engine and the engine, held against the JAX package's.

Each scenario drives the JAX module and the port's on one fake clock and
one event sequence and asserts the same events (seq, actor, action,
subject, trigger, cause; the wall stamps apart), the same ``why`` chains
and the same snapshots. The scenarios mirror ``tests/test_journal.py``:
the ring's bound and re-rooting (:47), the SLO burn -> ladder escalate
chain through the real ladders (:116), the REST kill switch (:237, on the
port's server) and the replay pin (:319): the engine's result fold is
bit-identical with the journal, the tracer and the stage records on and
off.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_edge_ai_proxy_tpu.models import yolov8 as jyolo
from video_edge_ai_proxy_tpu.obs import journal as jjournal
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.obs import slo as jslo
from video_edge_ai_proxy_tpu.obs import watch as jwatch
from video_edge_ai_proxy_tpu.resilience import ladder as jladder
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
from video_edge_ai_proxy_tpu_torch.models.carry import from_flax
from video_edge_ai_proxy_tpu_torch.obs import journal, metrics, slo, spans, watch
from video_edge_ai_proxy_tpu_torch.replay import checksum, player, recorder
from video_edge_ai_proxy_tpu_torch.resilience import ladder
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

PACKAGES = {"jax": (jjournal, jladder, jslo, jwatch, jmetrics),
            "port": (journal, ladder, slo, watch, metrics)}


class Clock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def stable(events):
    """Journal events without their wall stamps, JSON-normalised. The
    watchdog times its episodes on the wall clock (not injectable), so a
    closed episode's ``duration_s`` goes too."""
    out = json.loads(json.dumps([{k: v for k, v in e.items() if k != "ts"} for e in events]))
    for e in out:
        if e["actor"] == "watch" and e["trigger"]:
            e["trigger"].pop("duration_s", None)
    return out


def stable_why(out):
    return {**out, "chain": stable(out["chain"])}


def both(fn):
    """``fn(package modules)`` for the JAX package and the port."""
    return {tag: fn(*mods) for tag, mods in PACKAGES.items()}


def equal(results):
    assert results["port"] == results["jax"]
    return results["port"]


# -- the ring ---------------------------------------------------------------------------


def test_record_events_filters_and_latest_seq_equal_jax():
    def run(jmod, *_):
        j = jmod.DecisionJournal(16, clock=Clock(), registry=_[-1].Registry())
        s1 = j.record("slo", "episode_open", subject=("slo", "lat"), trigger={"fast": 20.0})
        j.record("ladder", "escalate", subject=("ladder", "engine"), trigger={"to": "shed"},
                 cause=s1)
        return {"all": stable(j.events()), "ladder": stable(j.events(actor="ladder")),
                "subject": stable(j.events(subject=("slo", "lat"))),
                "kind": stable(j.events(subject_kind="ladder")),
                "since": stable(j.events(since=1)), "limit": stable(j.events(limit=1)),
                "latest": j.latest_seq(actor="slo", action="episode_open"),
                "event": stable([j.event(2)]), "next": j.next_seq,
                "window": stable(j.window(99.0, 101.0)), "none": j.window(0.0, 1.0)}
    out = equal(both(run))
    assert [e["seq"] for e in out["all"]] == [1, 2] and out["latest"] == 1


@pytest.mark.parametrize("capacity,n", [(16, 40), (8, 8), (32, 5)])
def test_ring_bound_eviction_and_snapshot_equal_jax(capacity, n):
    def run(jmod, *rest):
        reg = rest[-1].Registry()
        j = jmod.DecisionJournal(capacity, clock=Clock(), registry=reg)
        for i in range(n):
            j.record("engine", "tickmark", subject=("engine", "dispatch"), trigger={"i": i})
        snap = j.snapshot(tail=4)
        snap["tail"] = stable(snap["tail"])
        fam = {name: [s["value"] for s in v["samples"]]
               for name, v in reg.snapshot().items()}
        return {"snap": snap, "events": stable(j.events()), "first": j.event(1) is None,
                "metrics": fam}
    out = equal(both(run))
    assert out["snap"]["capacity"] == max(16, capacity)


def test_why_re_roots_when_the_cause_falls_off_the_ring_equal_jax():
    def run(jmod, *rest):
        j = jmod.DecisionJournal(16, clock=Clock(), registry=rest[-1].Registry())
        prev = None
        for i in range(40):
            prev = j.record("engine", "step", subject=("stream", "cam0"), trigger={"i": i},
                            cause=prev)
        return [stable_why(j.why("stream", "cam0", max_links=m)) for m in (4, 32)]
    out = equal(both(run))
    assert out[1]["evicted_root"] and out[1]["text"][0] == "(root evicted from journal ring)"


def test_why_of_subjects_the_port_cannot_produce_answers_as_jax_unknown():
    """ROI mode, the cascade stretch, failover, the router and the
    supervisor have no source in the port: ``why`` on their subjects
    answers as JAX answers any subject nothing recorded."""
    subjects = [("stream", "cam0"), ("member", "m1"), ("shard", "0"), ("tenant", "t"),
                ("router", "fleet"), ("supervisor", "fleet")]

    def run(jmod, *rest):
        j = jmod.DecisionJournal(8, clock=Clock(), registry=rest[-1].Registry())
        j.record("ladder", "escalate", subject=("ladder", "engine"), trigger={"to": "shed"})
        return [j.why(k, i) for k, i in subjects]
    out = equal(both(run))
    assert all(not o["found"] and o["chain"] == [] for o in out)


@pytest.mark.parametrize("trigger", [{"to": "shed", "slo_burning": True},
                                     {"fast": 1.25, "slow": 3.0, "n": 7}, None])
def test_format_event_equal_jax(trigger):
    ev = {"seq": 3, "actor": "ladder", "action": "escalate", "subject": ("ladder", "engine"),
          "trigger": trigger, "cause": None, "ts": 1.0}
    assert journal.format_event(ev) == jjournal.format_event(ev)


# -- the chains through the real ladders and SLOs ----------------------------------------------


def _burn_chain(jmod, lmod, *rest):
    """A fresh escalation under SLO burn roots at the SLO's episode_open."""
    clk = Clock()
    j = jmod.DecisionJournal(64, clock=clk, registry=rest[-1].Registry())
    slo_seq = j.record("slo", "episode_open", subject=("slo", "detect_latency_p50"),
                       trigger={"fast": 40.0, "slow": 22.0, "threshold": 1.2})
    lad = lmod.DegradationLadder(escalate_after_s=0.1, clock=clk, journal=j)
    rungs = []
    for _ in range(2):
        rungs.append(lad.observe(queue_depth=0, tick_lag_s=0.0, tick_budget_s=0.01,
                                 slo_burning=True))
        clk.advance(0.2)
    return {"rungs": rungs, "slo_seq": slo_seq, "last": lad.last_transition_seq,
            "events": stable(j.events()), "why": stable_why(j.why("ladder", "engine"))}


def test_slo_burn_roots_the_ladder_chain_equal_jax():
    out = equal(both(_burn_chain))
    esc = out["events"][-1]
    assert out["rungs"] == ["normal", "shed"]
    assert esc["action"] == "escalate" and esc["cause"] == out["slo_seq"]
    assert esc["trigger"]["slo_burning"] is True and esc["trigger"]["hbm_pressure"] is False
    assert [e["action"] for e in out["why"]["chain"]] == ["episode_open", "escalate"]


def _walk(jmod, lmod, *rest):
    """Deeper escalations chain to the previous transition, recoveries to
    the escalation they undo; the watchdog holds one engine_degraded
    episode over the excursion (rungs below bucket_downshift, where the
    two ladders' rung indices agree: the JAX one has shed_to_fleet)."""
    clk = Clock()
    j = jmod.DecisionJournal(64, clock=clk, registry=rest[-1].Registry())
    wd = rest[1].Watchdog(journal=j)
    lad = lmod.DegradationLadder(escalate_after_s=0.1, recover_after_s=0.1, clock=clk,
                                 journal=j, watchdog=wd)
    seen = []
    for depth in (9, 9, 0, 0, 9, 9, 0, 0, 0):
        seen.append(lad.observe(queue_depth=depth, tick_lag_s=0.0, tick_budget_s=0.01))
        clk.advance(0.2)
    snap = wd.snapshot()
    return {"rungs": seen, "events": stable(j.events()), "episodes": snap["episodes"],
            "active": sorted(snap["active"]),
            "last": {k: {f: v[f] for f in ("peak", "threshold", "direction")}
                     for k, v in snap["last"].items()},
            "why": stable_why(j.why("watch", "engine_degraded"))}


def test_transition_causes_and_degraded_episodes_equal_jax():
    out = equal(both(_walk))
    escs = [e for e in out["events"] if e["action"] == "escalate"]
    recs = [e for e in out["events"] if e["action"] == "recover"]
    assert escs and recs and escs[0]["cause"] is None
    assert recs[0]["cause"] == escs[0]["seq"]
    assert out["episodes"] == {"engine_degraded": 2}


def _slo_episode(jmod, lmod, smod, wmod, mmod):
    """A real BurnRateSLO on fake time: warmup, a burn that opens one
    episode (journaled, watchdog slo_burn:<name>), recovery that closes it
    caused by its open, and the ladder's escalation rooted there."""
    clk = Clock(0.0)
    reg = mmod.Registry()
    j = jmod.DecisionJournal(64, clock=clk, registry=reg)
    wd = wmod.Watchdog(journal=j)
    eng = smod.SLOEngine([smod.SLOSpec("lat", 0.5, fire_burn_rate=1.2, warmup_s=5.0,
                                       fast_window_s=30.0, slow_window_s=60.0, bin_s=1.0)],
                         clock=clk, registry=reg, watchdog=wd, journal=j)
    lad = lmod.DegradationLadder(escalate_after_s=0.5, recover_after_s=0.5, clock=clk,
                                 journal=j, watchdog=wd)
    burning = []
    for t in range(60):
        bad = 5 <= t < 40
        eng.record("lat", good=0.0 if bad else 1.0, bad=1.0 if bad else 0.0)
        verdict = eng.evaluate()
        burning.append(verdict["burning"])
        lad.observe(queue_depth=0, tick_lag_s=0.0, tick_budget_s=0.01,
                    slo_burning=verdict["burning"])
        clk.advance(1.0)
    state = eng.snapshot()
    return {"burning": burning, "state": state, "events": stable(j.events()),
            "last_open": eng.get("lat").last_open_seq,
            "episodes": wd.snapshot()["episodes"],
            "why_ladder": stable_why(j.why("ladder", "engine")),
            "why_slo": stable_why(j.why("slo", "lat"))}


def test_slo_episodes_watchdog_and_ladder_chain_equal_jax():
    # The rungs are JAX's five, so the engine_degraded episode's value and
    # peak (a rung index) compare directly.
    assert ladder.RUNGS == jladder.RUNGS
    out = equal(both(_slo_episode))
    acts = [(e["actor"], e["action"]) for e in out["events"]]
    assert ("slo", "episode_open") in acts and ("slo", "episode_close") in acts
    assert out["episodes"]["slo_burn:lat"] == 1
    assert out["why_slo"]["chain"][0]["action"] == "episode_open"


# -- the REST kill switch (the port's server) ------------------------------------------------


class _PM:
    def list(self):
        return []


@pytest.mark.parametrize("on", [False, True])
def test_journal_routes_follow_the_kill_switch(on):
    from video_edge_ai_proxy_tpu_torch.serve.rest_api import RestServer

    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2),
                                            journal=on), device="cpu")
    assert (eng.journal is not None) is on
    assert (eng.ladder.journal is not None) is on and (eng.slo.journal is not None) is on
    if on:
        s1 = eng.journal.record("slo", "episode_open", subject=("slo", "lat"),
                                trigger={"fast": 2.0})
        eng.journal.record("ladder", "escalate", subject=("ladder", "engine"),
                           trigger={"to": "shed"}, cause=s1)
    srv = RestServer(_PM(), None, host="127.0.0.1", port=0, engine=eng)
    srv.start()
    base = f"http://127.0.0.1:{srv.bound_port}"
    try:
        if not on:
            for path in ("/api/v1/journal", "/api/v1/why?stream=cam0"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(base + path, timeout=10)
                assert err.value.code == 400
                body = json.loads(err.value.read())
                assert set(body) == {"code", "message"} and "engine.journal" in body["message"]
            return
        with urllib.request.urlopen(base + "/api/v1/journal?actor=ladder", timeout=10) as r:
            body = json.loads(r.read())
        assert [e["action"] for e in body["events"]] == ["escalate"] and body["next_seq"] == 3
        with urllib.request.urlopen(base + "/api/v1/why?subject=ladder:engine", timeout=10) as r:
            why = json.loads(r.read())
        assert why["found"] and why["links"] == 2 and why["chain"][0]["actor"] == "slo"
        with urllib.request.urlopen(base + "/api/v1/stats", timeout=10) as r:
            assert json.loads(r.read())["obs"]["journal"]["recorded"] == 2
        for path in ("/api/v1/why", "/api/v1/journal?since=x"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + path, timeout=10)
            assert err.value.code == 400
    finally:
        srv.stop()
        bus.close()


# -- the replay pin ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fold_inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("pin") / "pin.vtrace"
    recorder.record_synthetic_trace(str(path), ["cam0", "cam1"], width=96, height=64,
                                    frames=3)
    model = jyolo.YOLOv8(jyolo.tiny_yolov8_config(), dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    return str(path), checksum.zero_class_prior(from_flax(v))


def _fold(path, state, **cfg):
    engine = InferenceEngine(MemoryFrameBus(), EngineConfig(model="tiny_yolov8", **cfg),
                             device="cpu")
    engine._model = engine._spec.init_params(device="cpu", dtype=torch.float32)
    engine._model.load_state_dict(state)
    by_packet: dict = {}
    for dev, frame, meta in player.TracePlayer(path).iter_frames():
        by_packet.setdefault(meta.packet, []).append((dev, frame, meta))
    return engine.serve_lockstep(by_packet[p] for p in sorted(by_packet)), engine


def test_replay_fold_is_bit_identical_with_the_audit_planes_on_and_off(fold_inputs):
    path, state = fold_inputs
    off, eng_off = _fold(path, state, journal=False, prof=False, prefetch=False)
    assert eng_off.journal is None and eng_off.prof is None
    spans.tracer.configure(enabled=True, sample_every=1)
    try:
        on, eng_on = _fold(path, state, journal=True, stage_trace=True, prefetch=False)
        events = spans.tracer.events()
    finally:
        spans.tracer.configure(enabled=False, sample_every=16)
        spans.tracer.clear()
    assert on == off != 0
    assert len(eng_on.stage_records) == 6
    assert {e["stage"] for e in events} >= {"collect", "submit", "device", "emit"}
    legs = spans.stage_breakdown(events)
    assert legs["batch"]["count"] == legs["device"]["count"] == 6
    piped, _ = _fold(path, state, journal=True, prefetch=True)
    assert piped == off


def test_the_engine_journals_the_shed_excursion_caused_by_the_ladder():
    """The engine's shed_open is caused by the transition that engaged
    shedding, and shed_close by its shed_open once the ladder is back at
    normal (``_shed_stale_groups`` and ``_tick``'s edge)."""
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta

    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", batch_buckets=(1, 2)),
                          device="cpu")
    clk = Clock()
    eng.ladder._clock = clk
    for _ in range(2):
        eng.ladder.observe(queue_depth=9, tick_lag_s=0.0, tick_budget_s=0.01)
        clk.advance(1.0)
    assert eng.ladder.rung == "shed"
    bus.create_stream("cam0", 32 * 32 * 3)
    bus.publish("cam0", np.zeros((32, 32, 3), np.uint8),
                FrameMeta(width=32, height=32, channels=3, packet=1,
                          timestamp_ms=int(time.time() * 1000) - 10_000))
    groups = eng._collector.collect(device_ids=["cam0"])
    assert eng._shed_stale_groups(groups) == []
    eng._close_shed_excursion()
    (esc,) = stable(eng.journal.events(actor="ladder"))
    opened, closed = stable(eng.journal.events(actor="engine"))
    assert (esc["action"], opened["action"], closed["action"]) == \
        ("escalate", "shed_open", "shed_close")
    assert opened["cause"] == esc["seq"] and closed["cause"] == opened["seq"]
    assert opened["trigger"] == {"frames": 1, "staleness_ms": 500.0}
    assert closed["trigger"] == {"frames": 1}
    bus.close()

"""The port's device-fault domain (``engine/fault.py``, the engine's
failover, ``/api/v1/faults``) held against the JAX package's, case for case
with ``tests/test_fault.py``.

- ``FaultLedger`` and ``FaultPlane``: the same tap sequences on a fake
  clock through both packages; every balance, window, pending map and
  snapshot equal (event wall stamps aside), the JAX tests' own asserts on
  the port's side, the ``vep_fault_*`` families equal and lint-clean.
- ``stream_shard`` and ``make_repin`` equal to JAX's over many stream sets
  (hypothesis), composed across cascaded faults.
- ``_PrefetchStage``'s double-buffer parity restarts at slot 0 across a
  rebuild.
- The engine, hand-stepped, each package on a dp=2 mesh (JAX on the
  conftest's virtual CPU devices, the port on two ``cpu`` slots) of
  ``tiny_blob_gauge``: one step error attributed to slot 1, the failover to
  dp=1, the same failover event (survivors, dead slots, stream census,
  evacuation), the same ledger, the same results after it. And the port's
  engine live (its tick thread) through the same fault, as JAX's
  ``TestEngineFailover``.
- ``/api/v1/faults`` and ``stats.faults`` of both REST apps, the domain on
  and off; the kill switch (``fault=False`` folds the same); a mesh larger
  than the slot list raises.
"""

import asyncio
import queue
import threading
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_edge_ai_proxy_tpu.bus.interface import FrameMeta as JFrameMeta
from video_edge_ai_proxy_tpu.bus.memory_bus import MemoryFrameBus as JMemoryFrameBus
from video_edge_ai_proxy_tpu.engine import collector as jcollector
from video_edge_ai_proxy_tpu.engine import fault as jfault
from video_edge_ai_proxy_tpu.engine import runner as jrunner
from video_edge_ai_proxy_tpu.obs import metrics as jmetrics
from video_edge_ai_proxy_tpu.uplink.queue import AnnotationQueue as JAnnotationQueue
from video_edge_ai_proxy_tpu.utils.config import EngineConfig as JEngineConfig
from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
from video_edge_ai_proxy_tpu_torch.engine import collector
from video_edge_ai_proxy_tpu_torch.engine import fault
from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine, _PrefetchStage
from video_edge_ai_proxy_tpu_torch.models.blob import blob_color
from video_edge_ai_proxy_tpu_torch.obs import metrics
from video_edge_ai_proxy_tpu_torch.uplink import AnnotationQueue
from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside five other test workers
    the default (every core) oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = float(now)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _scrub(obj):
    """A snapshot without the events' wall stamps (``time.time()``)."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


# -- the ledger and the plane: the same scripts through both packages -----------


def _err(shard=None, text="device halted"):
    exc = RuntimeError(text)
    if shard is not None:
        exc.fault_shard = shard
    return exc


def led_all_emitted(m, clock):
    led = m.FaultLedger(clock=clock)
    led.note_dispatched(3)
    for i in range(3):
        led.note_emitted("cam0", (0, 100 + i))
    b = led.balance()
    assert b["lost"] == 0 and b["lost_outside_window"] == 0
    return [b]


def led_drop_outside_window(m, clock):
    led = m.FaultLedger(clock=clock)
    led.note_dispatched(2)
    led.note_dropped(2, "device_fault")
    b = led.balance()
    assert b["lost"] == 0 and b["lost_outside_window"] == 2
    return [b]


def led_drop_inside_window(m, clock):
    led = m.FaultLedger(clock=clock)
    led.note_dispatched(2)
    led.open_window("xla_error")
    clock.advance(0.25)
    led.note_dropped(2, "device_fault")
    led.close_window()
    b = led.balance()
    assert b["lost_outside_window"] == 0 and b["windows"][0]["closed"] is not None
    return [b]


def led_residual_lost(m, clock):
    led = m.FaultLedger(clock=clock)
    led.note_dispatched(5)
    for i in range(3):
        led.note_emitted("cam0", (0, i))
    b = led.balance()
    assert b["lost"] == 2 and b["lost_outside_window"] == 2
    return [b]


def led_duplicate_and_rebase(m, clock):
    led = m.FaultLedger(clock=clock)
    out = []
    for stream, key in (("cam0", (0, 100)), ("cam0", (0, 101)), ("cam1", (0, 101)),
                        ("cam0", (0, 101)), ("cam0", (0, 7))):
        led.note_emitted(stream, key)
        out.append(led.balance())
    assert out[-1]["rebased"] == 1 and out[-1]["duplicated"] == 1
    return out


def led_window_reopen(m, clock):
    led = m.FaultLedger(clock=clock)
    led.open_window("xla_error")
    led.open_window("stall")
    open_ = led.window_open
    clock.advance(1.0)
    led.close_window()
    led.close_window()
    assert open_ and not led.window_open
    return [open_, led.window_open, led.balance()]


def _plane(m, clock, **kw):
    kw.setdefault("shards", 4)
    kw.setdefault("deadline_ms", 100.0)
    kw.setdefault("hysteresis", 2)
    return m.FaultPlane(clock=clock, **kw)


def plane_fault_shard_attr(m, clock):
    plane = _plane(m, clock)
    got = plane.note_error(_err(2), tick=7)
    assert got == 2 and plane.pending() == {2: "xla_error"} and plane.ledger.window_open
    return [got, plane.pending(), plane.snapshot()]


def plane_device_name(m, clock):
    plane = _plane(m, clock)
    plane.set_shard_devices({0: ["dev_0"], 1: ["dev_1"]})
    got = plane.note_error(_err(text="compile failed on dev_1: dead"), tick=3)
    assert got == 1
    return [got, plane.pending(), plane.snapshot()]


def plane_unattributable(m, clock):
    plane = _plane(m, clock)
    plane.set_shard_devices({0: ["dev_0"]})
    got = plane.note_error(ValueError("plain bug"), tick=1)
    assert got is None and plane.pending() == {} and not plane.ledger.window_open
    return [got, plane.snapshot()]


def plane_hysteresis(m, clock):
    plane = _plane(m, clock, deadline_ms=100.0, hysteresis=2)
    seen = []
    for ms in (250.0, 40.0, 250.0, 250.0):
        plane.note_drain(ms)
        clock.advance(0.01)
        seen.append(plane.stall_suspected())
    assert seen == [False, False, False, True]
    return [seen, plane.snapshot()]


def plane_resolve_marks(m, clock):
    plane = _plane(m, clock)
    plane.note_drain(250.0)
    plane.note_drain(250.0)
    marked = plane.resolve_stall([3], tick=11)
    assert marked == [3] and not plane.stall_suspected()
    return [marked, plane.pending(), plane.snapshot()]


def plane_resolve_empty(m, clock):
    plane = _plane(m, clock)
    plane.note_drain(250.0)
    plane.note_drain(250.0)
    marked = plane.resolve_stall([], tick=11)
    assert marked == [] and not plane.ledger.window_open
    return [marked, plane.snapshot()]


def plane_clear_pending(m, clock):
    plane = _plane(m, clock)
    plane.note_error(_err(0), tick=1)
    clock.advance(0.5)
    plane.clear_pending("no_survivors")
    assert plane.pending() == {} and not plane.ledger.window_open
    return [plane.snapshot()]


def plane_failover(m, clock):
    plane = _plane(m, clock, shards=4)
    plane.note_error(_err(1), tick=5)
    clock.advance(0.1)
    plane.note_failover({
        "tick": 6, "kinds": ["xla_error"], "shards_dead": [1], "survivors": 3,
        "failover_ms": 12.5, "over_budget": False, "evacuated": {"quality_thumbs": 8},
        "streams": {"total": 8, "kept": 6, "repinned": 2}})
    snap = plane.snapshot()
    assert snap["shards"] == 3 and snap["failovers"] == 1 and snap["active"] is False
    plane.configure(shards=3, shard_devices={0: ["a"], 1: ["b"], 2: ["c"]})
    return [snap, plane.snapshot(), plane.note_error(_err(text="on b: gone"), tick=9)]


def plane_drops(m, clock):
    plane = _plane(m, clock)
    plane.note_dropped(3, "shutdown_drain")
    plane.note_dropped(0, "dispatch_error")
    plane.ledger.note_dispatched(5)
    return [plane.snapshot()]


SCRIPTS = [led_all_emitted, led_drop_outside_window, led_drop_inside_window, led_residual_lost,
           led_duplicate_and_rebase, led_window_reopen, plane_fault_shard_attr,
           plane_device_name, plane_unattributable, plane_hysteresis, plane_resolve_marks,
           plane_resolve_empty, plane_clear_pending, plane_failover, plane_drops]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__)
def test_ledger_and_plane_equal_jax(script):
    mine = script(fault, FakeClock())
    theirs = script(jfault, FakeClock())
    assert _scrub(mine) == _scrub(theirs)


def _families(text: str, prefix: str) -> dict:
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ") and line.split()[2].startswith(prefix)}


def test_fault_families_equal_jax_and_lint_clean():
    for m in (fault, jfault):
        plane = m.FaultPlane(shards=2)
        plane.note_error(_err(1), tick=1)
        plane.note_dropped(1, "device_fault")
        plane.note_drain(1e9)
        plane.note_failover({"survivors": 1, "failover_ms": 3.0, "shards_dead": [1],
                             "evacuated": {"quality_thumbs": 2}})
    mine = metrics.registry.render()
    theirs = jmetrics.registry.render()
    assert _families(mine, "vep_fault_") == _families(theirs, "vep_fault_")
    assert len(_families(mine, "vep_fault_")) == 7
    assert [p for p in metrics.lint_exposition(mine) if "vep_fault" in p] == []


# -- routing: stream_shard and make_repin ------------------------------------------------

_ids = st.lists(st.text(alphabet="abcdefghijklmnopqrstuvwxyz0123456789_-", min_size=1,
                        max_size=12), min_size=1, max_size=40, unique=True)


@settings(max_examples=60, deadline=None)
@given(ids=_ids, shards=st.integers(1, 8), data=st.data())
def test_stream_shard_and_repin_equal_jax(ids, shards, data):
    assert [collector.stream_shard(d, shards) for d in ids] == \
        [jcollector.stream_shard(d, shards) for d in ids]
    if shards < 2:
        return
    dead = data.draw(st.sets(st.integers(0, shards - 1), min_size=1, max_size=shards - 1))
    mine = collector.make_repin(lambda d: collector.stream_shard(d, shards), shards, dead)
    theirs = jcollector.make_repin(lambda d: jcollector.stream_shard(d, shards), shards, dead)
    assert [mine(d) for d in ids] == [theirs(d) for d in ids]
    left = shards - len(dead)
    if left >= 2:
        # A second fault composes on the first's map (cascaded faults).
        dead2 = data.draw(st.sets(st.integers(0, left - 1), min_size=1, max_size=left - 1))
        mine2 = collector.make_repin(mine, left, dead2)
        theirs2 = jcollector.make_repin(theirs, left, dead2)
        assert [mine2(d) for d in ids] == [theirs2(d) for d in ids]
        assert all(0 <= mine2(d) < left - len(dead2) for d in ids)


@pytest.mark.parametrize("case", ["survivors_keep_pins", "dead_land_on_survivors",
                                  "composition"])
def test_make_repin_contract(case):
    """JAX's TestMakeRepin on the port's make_repin."""
    base = lambda d: collector.stream_shard(d, 4)  # noqa: E731
    repin = collector.make_repin(base, 4, dead=[1])
    ids = [f"cam{i}" for i in range(64)]
    if case == "survivors_keep_pins":
        renumber = {0: 0, 2: 1, 3: 2}
        assert all(repin(d) == renumber[base(d) % 4] for d in ids if base(d) % 4 != 1)
    elif case == "dead_land_on_survivors":
        again = collector.make_repin(base, 4, dead=[1])
        moved = [d for d in ids if base(d) % 4 == 1]
        assert moved and all(0 <= repin(d) < 3 and repin(d) == again(d) for d in moved)
    else:
        second = collector.make_repin(repin, 3, dead=[0])
        keep = [d for d in ids if base(d) % 4 == 2]
        assert all(0 <= second(d) < 2 for d in ids)
        assert keep and all(second(d) == 0 for d in keep)
    with pytest.raises(ValueError):
        collector.make_repin(base, 2, dead=[0, 1])


# -- the prefetch parity across a rebuild -----------------------------------------------


def test_prefetch_parity_restarts_at_slot_zero_after_reset():
    """JAX's TestPrefetchParityAcrossRebuild on the port's stage."""
    stage = _PrefetchStage(torch.device("cpu"), queue.Queue(), shards=2)
    stop = threading.Event()

    def group(sharded=True):
        return types.SimpleNamespace(model="tiny_blob_gauge", src_hw=(64, 64), bucket=4,
                                     rows=(0, 1) if sharded else None,
                                     frames=np.zeros((4, 64, 64, 3), np.uint8))

    p0, p1 = stage.submit(group(), stop), stage.submit(group(), stop)
    assert (p0.slot, p1.slot) == (0, 1)
    assert len(stage._slots) == 2
    stage._q.get_nowait(), stage._q.get_nowait()
    stage.reset(1)
    assert stage.shards == 1 and stage._slots == {}
    p2 = stage.submit(group(), stop)
    assert p2.slot == 0 and len(stage._slots) == 1


# -- the engine: a dp=2 mesh fails over to dp=1 -------------------------------------------

STREAMS = ["cam0", "cam1", "cam4", "cam5"]     # 2 a slot at dp=2 (crc32)


def _blob_frame(key: int, delta: int = 0):
    frame = np.full((64, 64, 3), 114, np.uint8)
    frame[20 + delta:40 + delta, 20:40] = blob_color(key)
    return frame


class _FaultPair:
    """A hand-stepped tiny_blob_gauge engine of each package on a dp=2 mesh
    with the fault domain on: JAX's on its virtual CPU devices, the port's
    on two cpu slots."""

    def __init__(self):
        base = dict(model="tiny_blob_gauge", batch_buckets=(2, 4), tick_ms=5, prefetch=False,
                    mesh={"dp": 2}, fault=True)
        self.bus, self.jbus = MemoryFrameBus(), JMemoryFrameBus()
        self.eng = InferenceEngine(self.bus, EngineConfig(**base), device="cpu",
                                   slots=["cpu", "cpu"],
                                   annotations=AnnotationQueue(handler=lambda b: True))
        self.jeng = jrunner.InferenceEngine(
            self.jbus, JEngineConfig(**base),
            annotations=JAnnotationQueue(handler=lambda b: True))
        self.subs = []
        for e in (self.eng, self.jeng):
            e.warmup()
            e._drain_q = queue.Queue(maxsize=8)
            q = queue.Queue()
            with e._sub_lock:
                e._subscribers.append((q, None))
            self.subs.append(q)
        for sid in STREAMS:
            self.bus.create_stream(sid, 64 * 64 * 3)
            self.jbus.create_stream(sid, 64 * 64 * 3)
        self.ts = 1_700_000_000_000

    def close(self):
        self.bus.close()
        self.jbus.close()

    def tick(self, step: int, fail_shard=None):
        """Publish one frame a stream and step each engine once; a
        ``fail_shard`` makes the step lookup raise an error attributed to
        it. Returns each package's results as (stream, ts, classes,
        boxes)."""
        self.ts += 33
        for i, sid in enumerate(STREAMS):
            frame = _blob_frame(i + 1, delta=step % 5)
            self.bus.publish(sid, frame, FrameMeta(width=64, height=64, channels=3,
                                                   timestamp_ms=self.ts, is_keyframe=True))
            self.jbus.publish(sid, frame, JFrameMeta(width=64, height=64, channels=3,
                                                     timestamp_ms=self.ts, is_keyframe=True))
        out = []
        for e, q in zip((self.eng, self.jeng), self.subs):
            groups = e._collector.collect()
            if fail_shard is not None:
                orig = e._step

                def boom(*a, **k):
                    raise _err(fail_shard, "injected: device of shard halted")

                e._step = boom
            try:
                e._dispatch(groups, time.time())
            except RuntimeError:
                pass   # JAX's dispatch re-raises the group's error (the port's logs it)
            finally:
                if fail_shard is not None:
                    e._step = orig
            while True:
                try:
                    inflight = e._drain_q.get_nowait()
                except queue.Empty:
                    break
                try:
                    e._emit(inflight)
                finally:
                    e._collector.release(inflight.group)
                    e._drain_q.task_done()
            e.ticks += 1
            res = []
            while not q.empty():
                r = q.get_nowait()
                res.append((r.device_id, r.timestamp, sorted(
                    (d.class_id, d.box.left, d.box.top, d.box.width, d.box.height)
                    for d in r.detections)))
            out.append(sorted(res))
        assert out[0] == out[1]
        return out[0]


def test_dp2_hard_fault_fails_over_to_dp1_equal_jax():
    pair = _FaultPair()
    try:
        for step in range(3):
            assert len(pair.tick(step)) == len(STREAMS)
        assert pair.tick(3, fail_shard=1) == []
        for e in (pair.eng, pair.jeng):
            assert e.faults.pending() == {1: "xla_error"}
            e._execute_failover()
        after = [pair.tick(step) for step in range(4, 7)]
        assert all({r[0] for r in res} == set(STREAMS) for res in after)
        snaps = [e.faults.snapshot() for e in (pair.eng, pair.jeng)]
        fo = [[ev for ev in s["events"] if ev["event"] == "failover"][0] for s in snaps]
        for key in ("survivors", "shards_dead", "streams", "evacuated", "kinds"):
            assert fo[0][key] == fo[1][key], key
        assert fo[0]["survivors"] == 1 and fo[0]["shards_dead"] == [1]
        ledgers = [s["ledger"] for s in snaps]
        for key in ("dispatched", "emitted", "dropped", "duplicated", "rebased", "lost",
                    "lost_outside_window"):
            assert ledgers[0][key] == ledgers[1][key], key
        assert ledgers[0]["lost"] == 0 and ledgers[0]["duplicated"] == 0
        assert ledgers[0]["lost_outside_window"] == 0
        assert ledgers[0]["dropped"] == {"device_fault": len(STREAMS)}
        assert len(ledgers[0]["windows"]) == 1 and ledgers[0]["windows"][0]["closed"]
        eng = pair.eng
        assert eng._shards == 1 and eng._mesh.shape["dp"] == 1
        assert eng._xfer.shards == 1 and eng._xfer._slots == {}
        assert snaps[0]["shards"] == 1 and snaps[0]["failovers"] == 1
    finally:
        pair.close()


def test_live_dp2_failover_detects_within_two_ticks_and_conserves():
    """The port's engine on its own tick thread through JAX's
    TestEngineFailover script: detection within 2 ticks, dp2 -> dp1, every
    stream served after, the ledger at 0 lost and 0 duplicated with the
    device_fault drops inside the window."""
    from video_edge_ai_proxy_tpu_torch.replay.faults import FaultEvent, ShardFaultInjector

    bus = MemoryFrameBus()
    eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge", mesh={"dp": 2},
                                            batch_buckets=(2, 4), tick_ms=10, prof=False,
                                            fault=True),
                          device="cpu", slots=["cpu", "cpu"],
                          annotations=AnnotationQueue(handler=lambda b: True))
    eng.warmup()
    for sid in STREAMS:
        bus.create_stream(sid, 64 * 64 * 3)
    results_q: queue.Queue = queue.Queue()
    with eng._sub_lock:
        eng._subscribers.append((results_q, None))
    injector = ShardFaultInjector(eng)
    results = []
    eng.start()
    try:
        deadline = time.monotonic() + 30.0
        ts = [int(time.time() * 1000)]

        def publish_until(cond):
            while not cond() and time.monotonic() < deadline:
                ts[0] += 20
                for i, sid in enumerate(STREAMS):
                    bus.publish(sid, _blob_frame(i + 1), FrameMeta(
                        width=64, height=64, channels=3, timestamp_ms=ts[0], is_keyframe=True))
                time.sleep(0.02)
                while not results_q.empty():
                    r = results_q.get_nowait()
                    if r is not None:
                        results.append((time.monotonic(), r))
            assert cond(), "timed out waiting for the engine"

        publish_until(lambda: len(results) >= 8)
        injector.fire(FaultEvent(at_s=0.0, kind="shard_fault", device_id="1"))
        publish_until(lambda: eng.faults.failovers >= 1)
        t_failover = time.monotonic()
        publish_until(lambda: {r.device_id for t, r in results if t > t_failover}
                      == set(STREAMS))
    finally:
        eng.stop()
        bus.close()
    snap = eng.faults.snapshot()
    det = [e for e in snap["events"] if e["event"] == "detected"]
    fo = [e for e in snap["events"] if e["event"] == "failover"]
    assert det[0]["kind"] == "xla_error" and det[0]["shard"] == 1
    assert det[0]["tick"] - injector.tick <= 2
    assert fo[0]["shards_dead"] == [1] and fo[0]["survivors"] == 1 and not fo[0]["over_budget"]
    ledger = snap["ledger"]
    assert ledger["lost"] == 0 and ledger["duplicated"] == 0
    assert ledger["lost_outside_window"] == 0 and ledger["dropped"].get("device_fault", 0) > 0
    assert ledger["windows"][0]["closed"] is not None


# -- REST and the kill switch ------------------------------------------------------------


def _rest_answers(build, engine):
    """(status, body) of /api/v1/faults and the stats embed from an aiohttp
    app built by ``build``."""
    from aiohttp.test_utils import TestClient, TestServer

    async def go():
        async with TestClient(TestServer(build(engine))) as client:
            r = await client.get("/api/v1/faults")
            body = await r.json()
            s = await client.get("/api/v1/stats")
            stats = await s.json()
            return r.status, body, stats

    return asyncio.run(go())


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_faults_route_and_stats_equal_jax(on):
    from video_edge_ai_proxy_tpu.serve import rest_api as jrest
    from video_edge_ai_proxy_tpu_torch.serve import rest_api

    cfg = dict(model="tiny_blob_gauge", batch_buckets=(1, 2), tick_ms=5, fault=on)
    bus, jbus = MemoryFrameBus(), JMemoryFrameBus()
    try:
        eng = InferenceEngine(bus, EngineConfig(**cfg), device="cpu")
        jeng = jrunner.InferenceEngine(jbus, JEngineConfig(**cfg))
        mine = _rest_answers(lambda e: rest_api.build_app(None, None, engine=e), eng)
        theirs = _rest_answers(_jax_app(jrest), jeng)
    finally:
        bus.close()
        jbus.close()
    assert mine[0] == theirs[0] == (200 if on else 400)
    assert set(mine[1]) == set(theirs[1])
    if on:
        assert _scrub(mine[1]) == _scrub(theirs[1])
        assert mine[2]["obs"]["faults"]["shards"] == mine[1]["shards"]
        assert set(mine[2]["obs"]["faults"]) == set(theirs[2]["obs"]["faults"])
    else:
        assert mine[1] == theirs[1]
        assert "engine.fault" in mine[1]["message"]
        assert mine[2]["obs"]["faults"] is None and theirs[2]["obs"]["faults"] is None


def _jax_app(jrest):
    """The JAX package's REST app (aiohttp) around an engine."""
    return lambda engine: jrest.build_app(None, None, engine=engine)


def test_fault_off_is_bit_identical_and_taps_nothing():
    """The kill switch: the same frames fold the same checksum with the
    domain on and off, and off there is no plane."""
    def fold(on):
        bus = MemoryFrameBus()
        try:
            eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge",
                                                    batch_buckets=(1, 2, 4), tick_ms=5,
                                                    prefetch=False, fault=on), device="cpu")
            ticks = [[(sid, _blob_frame(i + 1, delta=t), FrameMeta(
                width=64, height=64, channels=3, timestamp_ms=1000 + 33 * t, packet=t + 1))
                for i, sid in enumerate(STREAMS)] for t in range(3)]
            out = eng.serve_lockstep(ticks)
            if on:
                bal = eng.faults.ledger.balance()
                assert bal["dispatched"] == bal["emitted"] == 3 * len(STREAMS)
                assert bal["lost"] == 0
            else:
                assert eng.faults is None
            return out
        finally:
            bus.close()

    on, off = fold(True), fold(False)
    assert on == off != 0


@pytest.mark.parametrize("mesh,slots,error", [
    ({"dp": 2}, ["cpu"], ValueError),
    ({"dp": 4}, ["cpu", "cpu"], ValueError),
    ({"dp": 1, "tp": 2}, ["cpu", "cpu"], NotImplementedError),
    ("dp2", ["cpu"], ValueError),
], ids=["dp2_one_slot", "dp4_two_slots", "tp_later_slice", "bad_string"])
def test_mesh_the_slot_list_cannot_hold_raises_at_warmup(mesh, slots, error):
    bus = MemoryFrameBus()
    try:
        eng = InferenceEngine(bus, EngineConfig(model="tiny_blob_gauge", mesh=mesh),
                              device="cpu", slots=slots)
        with pytest.raises(error):
            eng.warmup()
    finally:
        bus.close()

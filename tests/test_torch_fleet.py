"""The port's fleet telemetry plane (``obs/fleet.py``, ``merge_journals``)
and the fleet routes against the JAX package's.

- ``parse_exposition`` parses the same pages alike; ``merge_journals``
  merges the same journals alike.
- ``FleetAggregator`` over the same scripted members (pages, stats, SLO,
  capacity and journals served from memory, a fake clock) gives equal
  health rows, merged counters, gauges and histograms, an equal merged
  page (lint clean, every sample with its ``instance``) and an equal
  merged journal; a member whose prewarm is incomplete is ``warming``.
- The new REST routes (``/api/v1/capacity``, ``/api/v1/fleet/*``,
  ``/api/v1/router/attach|detach``, ``/api/v1/supervisor``) answer as
  JAX's: the same status and body, off and on.
- ``run_fleet_obs`` with 2 CPU members (``tiny_yolov8`` at 128x96), each a
  process of its own, passes its six gates with bounded waits.
- ``InferenceEngine.at_rest``, which a member's counts are read through,
  reads between ticks once every dispatched batch is emitted, and after its
  timeout reads as things stand.
Tolerance: none.
"""

import asyncio
import json
import types

import pytest

from video_edge_ai_proxy_tpu.obs import fleet as jfleet
from video_edge_ai_proxy_tpu.obs import journal as jjournal
from video_edge_ai_proxy_tpu.obs.metrics import Registry as JRegistry
from video_edge_ai_proxy_tpu.resilience import ladder as jladder
from video_edge_ai_proxy_tpu.serve import rest_api as jrest
from video_edge_ai_proxy_tpu_torch.obs import capacity, fleet, journal
from video_edge_ai_proxy_tpu_torch.obs.metrics import Registry, lint_exposition
from video_edge_ai_proxy_tpu_torch.resilience import ladder
from video_edge_ai_proxy_tpu_torch.serve import rest_api


def _page(instance: str, scale: float) -> str:
    reg = Registry()
    if instance:
        reg.set_const_labels(instance=instance)
    reg.counter("vep_frames_total", "Frames", ("stream",)).labels("cam0").inc(10 * scale)
    reg.counter("vep_frames_total", "Frames", ("stream",)).labels("cam1").inc(3)
    reg.counter("vep_engine_ticks_total", "Ticks").labels().inc(100 * scale)
    reg.gauge("vep_ladder_rung", "Rung").labels().set(scale - 1)
    h = reg.histogram("vep_latency_ms", "Latency", ("stream",))
    for v in (1.0, 5.0, 40.0 * scale, 300.0):
        h.labels("cam0").observe(v)
    return reg.render()


PAGES = {"m0": _page("m0", 1.0), "m1": _page("m1", 2.0), "m2": _page("", 3.0)}


def test_parse_exposition_equal_jax():
    for page in list(PAGES.values()) + ['foreign_metric{a="b"} 2\n# junk\nplain 3.5\n']:
        assert fleet.parse_exposition(page) == jfleet.parse_exposition(page)
    assert fleet._strip_label('a="1",instance="m0",b="x"', "instance") == \
        jfleet._strip_label('a="1",instance="m0",b="x"', "instance") == 'a="1",b="x"'


def _journals(mod):
    j0 = mod.DecisionJournal(16, clock=lambda: 5.0)
    j1 = mod.DecisionJournal(16, clock=lambda: 5.0)
    j0.record("ladder", "escalate", subject=("ladder", "engine"), trigger={"to": "shed"})
    j1.record("router", "migrate", subject=("stream", "cam0"), trigger={"dst": "m0"})
    j0.record("slo", "episode_open", subject=("slo", "lat"))
    return {"m1": j1.events(), "m0": j0.events(), "m2": []}


def test_merge_journals_equal_jax():
    merged = journal.merge_journals(_journals(journal))
    assert merged == jjournal.merge_journals(_journals(jjournal))
    assert [(e["member"], e["seq"]) for e in merged] == [("m0", 1), ("m0", 2), ("m1", 1)]


def _member_stats(warming: bool) -> dict:
    return {"engine": {"streams": {"cam0": {"frames": 3}},
                       "prewarm": {"required": 2, "done": 1 if warming else 2,
                                   "complete": not warming, "aot_cache": True}},
            "obs": {}}


def _aggregate(mod, journal_mod, monkeypatch):
    clock = types.SimpleNamespace(t=100.0)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: clock.t))
    agg = mod.FleetAggregator([f"{n}=http://{n}" for n in PAGES] + ["http://dead"],
                              scrape_interval_s=1.0)
    cap = {"headroom": 0.75, "utilization": {"fast": 0.25}, "time_to_saturation_s": 300.0}
    journals = _journals(journal_mod)
    served = {}
    for n, page in PAGES.items():
        served[f"http://{n}/metrics"] = page
        served[f"http://{n}/api/v1/stats"] = json.dumps(_member_stats(n == "m2"))
        served[f"http://{n}/api/v1/slo"] = json.dumps({"burning": n == "m1"})
        if n != "m1":
            served[f"http://{n}/api/v1/capacity"] = json.dumps(cap)
        served[f"http://{n}/api/v1/journal"] = json.dumps({"events": journals[n]})

    def fetch(url):
        if url not in served:
            raise ConnectionError(url)
        return served[url].encode()

    agg._fetch = fetch
    agg.scrape_once()
    clock.t += 0.5
    agg.scrape_once()
    clock.t += 0.25
    out = {"health": agg.health(), "stats": agg.fleet_stats(),
           "page": agg.merged_exposition(), "journal": agg.merged_journal()}
    agg.add_member("http://late")
    agg.remove_member("m1")
    out["after"] = [r["instance"] for r in agg.health()]
    return json.loads(json.dumps(out))


def test_aggregator_equals_jax(monkeypatch):
    port = _aggregate(fleet, journal, monkeypatch)
    jax_ = _aggregate(jfleet, jjournal, monkeypatch)
    assert port == jax_
    assert not lint_exposition(port["page"])
    rows = {r["instance"]: r for r in port["health"]}
    assert rows["m2"]["warming"] and not rows["m0"]["warming"]
    assert rows["m3"]["up"] is False and rows["m1"]["slo_burning"]
    assert rows["m0"]["headroom"] == 0.75 and rows["m1"]["headroom"] is None
    assert port["stats"]["counters"]["vep_frames_total"]['stream="cam1"']["value"] == 9.0
    assert 'vep_frames_total{instance="m2",stream="cam0"} 30' in port["page"]


class _PM:
    def list(self):
        return []


def _routes(mod, ladder_mod, case):
    """(status, body) of each new route under ``case`` for one package."""
    engine = fleet_obj = sup = None
    lad = ladder_mod.DegradationLadder(clock=lambda: 0.0)
    if case == "on":
        cap = (capacity if mod is rest_api else jcapacity()).CapacityTracker(
            registry=(Registry() if mod is rest_api else JRegistry()), clock=lambda: 50.0)
        cap.note_batch("yolov8n", (1080, 1920), 4, 9.5, ["cam0", "cam1"], now=50.0)
        engine = types.SimpleNamespace(ladder=lad, capacity=cap)
        fleet_obj = types.SimpleNamespace(
            fleet_stats=lambda: {"members": 2, "health": []},
            merged_exposition=lambda: "vep_fleet_members 2\n",
            merged_journal=lambda: {"members": ["m0"], "events": []})
        sup = types.SimpleNamespace(snapshot=lambda: {"name": "supervisor0", "passes": 3})
    elif case == "planes_off":
        engine = types.SimpleNamespace(ladder=None, capacity=None)
    kw = {"fleet": fleet_obj, "supervisor": sup}

    async def go():
        from aiohttp.test_utils import TestClient, TestServer

        app = mod.build_app(_PM(), None, engine=engine, **kw)
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, path in (("get", "/api/v1/capacity"), ("get", "/api/v1/fleet/stats"),
                                 ("get", "/api/v1/fleet/metrics"),
                                 ("get", "/api/v1/fleet/journal"),
                                 ("post", "/api/v1/router/attach"), ("get", "/api/v1/router"),
                                 ("post", "/api/v1/router/detach"),
                                 ("get", "/api/v1/supervisor")):
                r = await getattr(client, method)(
                    path, json={"router": "r0", "url": "http://r0:9091"})
                body = await r.text()
                try:
                    body = json.loads(body)
                except ValueError:
                    pass
                out.append((path, r.status, body))
        return out

    return asyncio.new_event_loop().run_until_complete(go())


def jcapacity():
    from video_edge_ai_proxy_tpu.obs import capacity as mod

    return mod


@pytest.mark.parametrize("case", ["engine_off", "planes_off", "on"])
def test_the_new_routes_answer_as_jax(case):
    port = _routes(rest_api, ladder, case)
    jax_ = _routes(jrest, jladder, case)
    assert port == jax_
    statuses = {path: status for path, status, _ in port}
    if case == "on":
        assert set(statuses.values()) == {200}
        body = {path: b for path, _, b in port}
        assert body["/api/v1/router"]["fleet_attached"] is True
        assert body["/api/v1/router/detach"]["fleet_attached"] is False
    else:
        assert set(statuses.values()) == {400}


def test_run_fleet_obs_two_cpu_members_pass_the_gates(tmp_path):
    from video_edge_ai_proxy_tpu_torch.replay.harness import run_fleet_obs

    out = run_fleet_obs(n_members=2, duration_s=3.0, warmup_s=6.0, width=128, height=96,
                        model="tiny_yolov8", device="cpu", torch_threads=1,
                        workdir=str(tmp_path))
    gates = out["gates"]
    assert gates["stitched_traces"] >= 1
    assert all(v for k, v in gates.items() if k != "stitched_traces"), gates
    assert out["backend"] == "cpu" and all(out["client_results"])
    for name, run in out["member_runs"].items():
        # Served after the ready line: the boot's batches are its base.
        assert (run["counts"]["batches"].get("tiny_yolov8", 0)
                > run["ready_counts"]["batches"].get("tiny_yolov8", 0)), name
        assert run["torch_threads"] == 1


FORK_PROBE = """
import os, subprocess, sys, tempfile, threading, time
sys.path.insert(0, sys.argv[1])
from video_edge_ai_proxy_tpu_torch.serve.server import Server
from video_edge_ai_proxy_tpu_torch.utils.config import Config

d = tempfile.mkdtemp()
cfg = Config()
cfg.bus.backend = "memory"
cfg.annotation.endpoint = "http://127.0.0.1:1/annotate"
srv = Server(cfg, data_dir=d, grpc_port=0, rest_port=0)
srv.start()
import grpc
from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2 as pb
from video_edge_ai_proxy_tpu_torch.proto import video_streaming_pb2_grpc as pb_grpc
stop = threading.Event()

def calls():
    with grpc.insecure_channel(f"127.0.0.1:{srv.bound_grpc_port}") as ch:
        stub = pb_grpc.ImageStub(ch)
        while not stop.is_set():
            try:
                list(stub.ListStreams(pb.ListStreamRequest(), timeout=1))
            except grpc.RpcError:
                pass

threads = [threading.Thread(target=calls, daemon=True) for _ in range(4)]
for t in threads:
    t.start()
time.sleep(0.5)
codes = [subprocess.Popen(["true"], preexec_fn=lambda: None).wait() for _ in range(40)]
stop.set()
for t in threads:
    t.join(5)
srv.stop()
print("fork-support", os.environ.get("GRPC_ENABLE_FORK_SUPPORT"), "codes", sorted(set(codes)))
"""


def test_a_server_forks_its_workers_without_grpc_fork_handlers():
    """The repair: with gRPC's fork handlers on, a worker forked while
    another thread was inside gRPC ran them in the child and could abort
    (SIGABRT on the card). ``Server.start`` turns them off before gRPC
    initialises, so no fork of the server runs them."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "GRPC_ENABLE_FORK_SUPPORT"}
    proc = subprocess.run([sys.executable, "-c", FORK_PROBE, root], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fork-support false codes [0]" in proc.stdout, proc.stdout
    assert "fork() handlers" not in proc.stderr


def _at_rest_stub():
    """The two members of an engine that ``at_rest`` reads: the tick lock
    and the drain queue."""
    import queue
    import threading

    return types.SimpleNamespace(_tick_lock=threading.Lock(), _drain_q=queue.Queue(maxsize=2))


def test_at_rest_reads_between_ticks_after_the_drain():
    """A fleet member's counts are read with no batch in flight:
    ``at_rest`` waits out the tick that is dispatching and the emit of
    every batch already dispatched, so a batch that has launched its keep
    mask has also counted as a batch."""
    import threading
    import time

    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine

    eng = _at_rest_stub()
    counts = {"launches": 0, "batches": 0}
    eng._tick_lock.acquire()                 # a tick dispatching
    counts["launches"] += 1
    eng._drain_q.put(object())

    def finish():
        time.sleep(0.1)
        eng._tick_lock.release()             # the tick ends
        time.sleep(0.1)
        eng._drain_q.get()                   # the batch's emit
        counts["batches"] += 1
        eng._drain_q.task_done()

    t = threading.Thread(target=finish)
    t.start()
    seen = InferenceEngine.at_rest(eng, lambda: (dict(counts), eng._tick_lock.locked()))
    t.join()
    assert seen == ({"launches": 1, "batches": 1}, True)
    assert not eng._tick_lock.locked()


def test_at_rest_reads_as_it_stands_after_its_timeout(caplog):
    """A drain that never comes (its thread died) does not hang the read:
    after the timeout it warns and reads, and leaves the tick lock free."""
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine

    eng = _at_rest_stub()
    eng._drain_q.put(object())
    with caplog.at_level("WARNING"):
        assert InferenceEngine.at_rest(eng, lambda: eng._drain_q.unfinished_tasks,
                                       timeout=0.1) == 1
    assert "not at rest" in caplog.text
    assert not eng._tick_lock.locked()

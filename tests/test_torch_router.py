"""The port's fleet router (``serve/router.py``) and the ladder's fifth
rung against the JAX package's, on a fake clock with scripted members (no
socket, no process; the soak with real members is
``tools/torch_router_smoke.py``, on the card in ``chip_smoke.py`` phase
22c).

- ``HashRing`` placements equal before and after a member leaves or joins
  and under weights.
- ``MigrationLedger`` verdicts equal over the same deliveries (gaps,
  duplicates, handoffs).
- ``StreamRouter`` decisions equal over one scripted fleet: placement,
  the shed_to_fleet and burn migrations with their budget, a dead
  member's failover at the replay cursor, the unhealthy verdict, admin
  moves, scale-in and scale-out, the headroom-aware admission storm, and
  the decision journal's events.
- The ladder's walks equal with and without a registered fleet callback;
  without one neither walk visits ``shed_to_fleet``.
- gRPC ``RouterState`` reports the fleet attachment as JAX's does.
Tolerance: none (the router's arithmetic is the same on both sides).
"""

import json
import types

import pytest

from video_edge_ai_proxy_tpu.obs import journal as jjournal
from video_edge_ai_proxy_tpu.resilience import breaker as jbreaker
from video_edge_ai_proxy_tpu.resilience import ladder as jladder
from video_edge_ai_proxy_tpu.serve import router as jrouter
from video_edge_ai_proxy_tpu.serve import server as jserver
from video_edge_ai_proxy_tpu_torch.obs import journal
from video_edge_ai_proxy_tpu_torch.resilience import breaker, ladder
from video_edge_ai_proxy_tpu_torch.serve import router
from video_edge_ai_proxy_tpu_torch.serve import server

PKGS = {"port": types.SimpleNamespace(router=router, ladder=ladder, breaker=breaker,
                                      journal=journal, server=server),
        "jax": types.SimpleNamespace(router=jrouter, ladder=jladder, breaker=jbreaker,
                                     journal=jjournal, server=jserver)}


def both(fn, *args):
    out = {name: fn(pkg, *args) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.now += s


class FakeMember:
    def __init__(self, name):
        self.name = name
        self.streams = {}          # stream -> scripted emitted-frame counts
        self.started = []
        self.stopped = []
        self.attached = None
        self.fail = False


class FakeClient:
    """MemberClient's surface over a FakeMember, with the package's own
    CircuitBreaker."""

    def __init__(self, pkg, member, clock):
        self.name = member.name
        self.member = member
        self.breaker = pkg.breaker.CircuitBreaker(
            f"router_{member.name}", failure_threshold=3, recovery_timeout_s=5.0, clock=clock)

    def _check(self):
        if self.member.fail:
            raise ConnectionError(f"{self.name} down")

    def start_stream(self, name, url, model="", policy=""):
        self._check()
        self.member.started.append((name, url, model))
        self.member.streams.setdefault(name, [0])

    def stop_stream(self, name):
        self._check()
        self.member.stopped.append(name)

    def stream_frames(self, name):
        self._check()
        script = self.member.streams.get(name)
        if not script:
            return None
        return script.pop(0) if len(script) > 1 else script[0]

    def attach_router(self, router_name, url=""):
        self._check()
        self.member.attached = router_name
        return {}

    def detach_router(self):
        self.member.attached = None


def _row(name, **over):
    row = {"instance": name, "up": True, "stale": False, "healthy": True, "score": 1.0,
           "score_ema": 1.0, "healthy_since_s": 100.0, "ladder_rung": 0.0,
           "slo_burning": False, "streams": 0}
    row.update(over)
    return row


class FakeFleet:
    def __init__(self, names):
        self._members = [types.SimpleNamespace(name=n, base_url=f"http://{n}") for n in names]
        self.rows = {n: _row(n) for n in names}

    def scrape_once(self):
        pass

    def health(self):
        return [dict(self.rows[m.name]) for m in self._members]

    def add_member(self, spec):
        name, _, url = spec.partition("=")
        self._members.append(types.SimpleNamespace(name=name, base_url=url))
        self.rows[name] = _row(name)
        return name

    def remove_member(self, name):
        self._members = [m for m in self._members if m.name != name]
        self.rows.pop(name, None)


def make_router(pkg, names=("m0", "m1", "m2"), **kw):
    clock = FakeClock()
    fleet = FakeFleet(names)
    members = {n: FakeMember(n) for n in names}

    def factory(n, url):
        members.setdefault(n, FakeMember(n))
        return FakeClient(pkg, members[n], clock)

    r = pkg.router.StreamRouter([f"{n}=http://{n}" for n in names], fleet=fleet,
                                client_factory=factory, clock=clock, sleep=clock.sleep,
                                drain_poll_s=0.1, drain_timeout_s=2.0, **kw)
    return r, fleet, members, clock


# -- consistent hashing -------------------------------------------------------------


def _ring(pkg):
    ring = pkg.router.HashRing(base_vnodes=64)
    for m in ("c", "a", "d", "b"):
        ring.add(m)
    keys = [f"cam{i}" for i in range(400)]
    out = {"all": [ring.place(k) for k in keys]}
    ring.remove("b")
    out["b_left"] = [ring.place(k) for k in keys]
    ring.add("e")
    out["e_joined"] = [ring.place(k) for k in keys]
    ring.set_weight("a", 0.25)
    out["a_weighted"] = [ring.place(k) for k in keys]
    out["exclude"] = [ring.place(k, exclude=("a", "c")) for k in keys[:50]]
    out["members"] = ring.members
    return out


def test_hash_ring_placements_equal_jax():
    out = both(_ring)
    # Survivors keep every key they had when a member leaves.
    assert all(after == before for before, after in zip(out["all"], out["b_left"])
               if before != "b")


# -- the conservation ledger ------------------------------------------------------------


def _ledger(pkg):
    led = pkg.router.MigrationLedger()
    for p in range(10):
        led.note_delivery("cam0", "m0", p, f"t{p}")
    for p in range(10, 16):
        led.note_delivery("cam0", "m1", p)
    for p in (0, 1, 2, 4, 5, 5, 6):       # a gap (3) and a duplicate (5)
        led.note_delivery("cam1", "m2", p)
    for p in (7, 9, 8):                   # out of order, gap-free
        led.note_delivery("cam1", "m0", p)
    led.record_migration({"stream": "cam0", "src": "m0", "dst": "m1", "ok": True})
    return {"balance": led.balance(), "cursor": [led.next_cursor(s) for s in
                                                 ("cam0", "cam1", "camX")],
            "migrations": list(led.migrations)}


def test_migration_ledger_equal_jax():
    out = both(_ledger)
    assert out["balance"]["lost"] == 1 and out["balance"]["duplicated"] == 1


# -- the router's decisions ---------------------------------------------------------------


def _scenario(pkg):
    j = pkg.journal.DecisionJournal(256, clock=lambda: 0.0)
    r, fleet, members, clock = make_router(pkg, max_moves_per_pass=1, journal=j)
    log = {"pass0": r.run_pass()["ring"], "attach": r.attach()}
    placed = {}
    for i in range(40):
        name = f"cam{i:03d}"
        owner = r.ring.place(name)
        if placed.get(owner, 0) >= 2:
            continue
        r.add_stream(name, f"replay:///t.vtrace?device={name}&pace=1", priority=i)
        placed[owner] = placed.get(owner, 0) + 1
        if len(placed) == 3 and all(v == 2 for v in placed.values()):
            break
    for name, rec in r.snapshot()["streams"].items():
        members[rec["member"]].streams[name] = [3, 5, 5]
        for p in range(5):
            r.ledger.note_delivery(name, rec["member"], p)
    fleet.rows["m0"].update(ladder_rung=float(pkg.ladder.RUNGS.index("shed_to_fleet")))
    log["shed"] = r.run_pass()["moved"]
    fleet.rows["m0"].update(slo_burning=True)
    log["burn"] = r.run_pass()["moved"]
    fleet.rows["m0"].update(slo_burning=False, ladder_rung=0.0)
    members["m1"].fail = True
    fleet.rows["m1"].update(up=False, stale=True)
    log["dead"] = r.run_pass()
    fleet.rows["m1"].update(up=True, stale=False)
    members["m1"].fail = False
    fleet.rows["m2"].update(healthy=False)
    log["unhealthy"] = r.run_pass()["moved"]
    fleet.rows["m2"].update(healthy=True)
    streams = sorted(r.snapshot()["streams"])
    log["admin"] = r.migrate(streams[0], reason="admin")
    r.add_member("m3", "http://m3")
    log["after_add"] = r.run_pass()["ring"]
    log["scale_in"] = r.remove_member("m0")
    log["streams"] = {n: (rec["member"], rec["migrations"])
                      for n, rec in sorted(r.snapshot()["streams"].items())}
    log["started"] = {n: m.started for n, m in sorted(members.items())}
    log["stopped"] = {n: m.stopped for n, m in sorted(members.items())}
    log["migrations"] = list(r.ledger.migrations)
    log["balance"] = r.ledger.balance()
    log["journal"] = [{k: v for k, v in ev.items() if k != "ts"} for ev in j.events()]
    log["clock"] = clock.now
    return json.loads(json.dumps(log, default=str))


def test_router_decisions_equal_jax():
    out = both(_scenario)
    reasons = [m["reason"] for m in out["migrations"]]
    assert {"shed_to_fleet", "slo_burn", "member_dead", "unhealthy", "admin",
            "scale_in"} <= set(reasons)
    # The dead member's streams resume at the ledger's cursor.
    dead = [m for m in out["migrations"] if m["reason"] == "member_dead"]
    assert dead and all(m["cursor"] == 5 and not m["graceful"] for m in dead)


def _admission(pkg):
    def cap_row(name, headroom, tts=None, **over):
        return _row(name, capacity=True, headroom=headroom,
                    capacity_utilization=None if headroom is None else 1.0 - headroom,
                    time_to_saturation_s=tts, **over)

    out = {}
    for label, rows in {
        "storm": [cap_row("m0", 0.9), cap_row("m1", 0.15, 25.0), cap_row("m2", 0.55, 400.0)],
        "tie": [cap_row("m0", 0.7), cap_row("m1", 0.15, 25.0), cap_row("m2", 0.7)],
        "unscored": [_row(n, score=0.0, score_ema=None) for n in ("m0", "m1", "m2")],
        "all_saturated": [cap_row("m0", 0.05, 10.0), cap_row("m1", 0.02, 5.0)],
    }.items():
        r, fleet, members, clock = make_router(pkg, names=[x["instance"] for x in rows],
                                               admit_saturation_horizon_s=60.0)
        fleet.rows = {x["instance"]: x for x in rows}
        r.run_pass()
        out[label] = [r.admit(f"{label}{i}", f"rtsp://{label}{i}", inference_model="m")
                      for i in range(12)]
    return out


def test_headroom_admission_equal_jax():
    out = both(_admission)
    assert set(out["storm"]) == {"m0"}


# -- the ladder's fifth rung ----------------------------------------------------------------


def _walk(pkg, registered):
    clk = FakeClock()
    lad = pkg.ladder.DegradationLadder(escalate_after_s=0.5, recover_after_s=2.0, clock=clk)
    edges = []
    if registered:
        lad.register_fleet(edges.append, {"router": "r0", "url": "http://r0"})
    rungs = []
    for depth in [9] * 24 + [0] * 40 + [9] * 6 + [0] * 10:
        clk.now += 0.25
        rungs.append(lad.observe(queue_depth=depth, tick_lag_s=0.0, tick_budget_s=1.0))
    if registered:
        lad.unregister_fleet()
        for _ in range(20):
            clk.now += 0.25
            rungs.append(lad.observe(queue_depth=9, tick_lag_s=0.0, tick_budget_s=1.0))
    return {"rungs": rungs, "edges": edges, "snapshot": lad.snapshot(),
            "fleet_info": lad.fleet_info, "index": lad.rung_index}


@pytest.mark.parametrize("registered", [False, True], ids=["no_router", "router"])
def test_ladder_walks_equal_jax(registered):
    assert ladder.RUNGS == jladder.RUNGS
    out = both(_walk, registered)
    visited = set(out["rungs"][:80])
    assert ("shed_to_fleet" in visited) == registered
    # The callback sees each entry and exit of the rung, alternating.
    edges = out["edges"]
    assert edges == [i % 2 == 0 for i in range(len(edges))]
    assert bool(edges) == registered


def test_the_walk_without_a_router_is_the_four_rung_walk():
    """The fifth rung changes nothing for an engine without a router: the
    walk visits the other four rungs in order, one per escalate window."""
    out = _walk(PKGS["port"], False)
    seen = []
    for r in out["rungs"]:
        if not seen or seen[-1] != r:
            seen.append(r)
    assert seen[:5] == ["normal", "shed", "bucket_downshift", "admission_pause",
                        "bucket_downshift"]
    assert "shed_to_fleet" not in out["snapshot"]["transitions"]


def _router_state(pkg):
    from concurrent import futures

    import grpc

    lad = pkg.ladder.DegradationLadder(clock=FakeClock())
    lad.register_fleet(lambda active: None, {"router": "r0", "url": "http://r0:9091",
                                             "via": "rest"})
    srv = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    srv.add_generic_rpc_handlers((pkg.server.make_admin_handler(
        types.SimpleNamespace(ladder=lad)),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            rpc = ch.unary_unary("/vep.Admin/RouterState", request_serializer=lambda b: b,
                                 response_deserializer=lambda b: b)
            return json.loads(rpc(b"", timeout=10))
    finally:
        srv.stop(0)


def test_grpc_router_state_reports_the_fleet_attachment_as_jax():
    out = both(_router_state)
    assert out["fleet_attached"] and out["fleet"]["router"] == "r0"


@pytest.mark.slow
def test_router_soak_on_cpu_members_passes_the_jax_gates(tmp_path):
    """The router soak with three CPU members, each a process of its own,
    through tools/torch_router_smoke.py's gates (about a minute: two 8 s
    escalations, the recovery walk, the kill leg)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_router_smoke", os.path.join(root, "tools", "torch_router_smoke.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from video_edge_ai_proxy_tpu_torch.replay.harness import run_router_soak

    out = run_router_soak(device="cpu", torch_threads=1, workdir=str(tmp_path))
    assert tool.router_failures(out) == []
    assert out["burn"]["transitions_at_migration"].get("shed_to_fleet", 0) >= 1

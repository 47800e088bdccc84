"""The port's autoscaling supervisor (``serve/supervisor.py``) and the
fleet tier's configuration against the JAX package's.

- ``FleetSupervisor`` over the same scripted fleet and fake clock makes the
  same decisions with the same reasons, records the same events and
  snapshot, and renders the same ``vep_supervisor_*`` families: the
  forecast spawn, the min and max bounds, the warming and cooldown holds,
  a failing spawner, the device-fault spawn, advisory mode, the surplus
  retire of the emptiest member, the surplus timer's reset, unreported
  capacity, a failing drain, the symmetric spawn cooldown after a retire.
- The same YAML gives equal ``EngineConfig`` capacity fields and equal
  ``obs``, ``router`` and ``supervisor`` sections in both packages.
Tolerance: none.
"""

import dataclasses
import json

import pytest

from video_edge_ai_proxy_tpu.obs import registry as jobs_registry
from video_edge_ai_proxy_tpu.serve import supervisor as jsupervisor
from video_edge_ai_proxy_tpu.utils import config as jconfig
from video_edge_ai_proxy_tpu_torch.obs import registry as obs_registry
from video_edge_ai_proxy_tpu_torch.obs.metrics import lint_exposition
from video_edge_ai_proxy_tpu_torch.serve import supervisor
from video_edge_ai_proxy_tpu_torch.utils import config

PKGS = {"port": supervisor, "jax": jsupervisor}


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeFleet:
    def __init__(self, router):
        self._router = router

    def health(self):
        return [dict(r) for r in self._router.rows.values()]


class FakeRouter:
    """The StreamRouter surface the supervisor uses, over scripted rows."""

    def __init__(self, members=("m0", "m1")):
        self.rows, self.clients, self.streams = {}, {}, {}
        self.added, self.removed = [], []
        self.fail_remove = False
        self.fleet = FakeFleet(self)
        for m in members:
            self.clients[m] = object()
            self.streams[m] = [f"{m}-cam0"]
            self.rows[m] = {"instance": m, "up": True, "stale": False, "warming": False,
                            "healthy": True, "headroom": 0.7, "time_to_saturation_s": None}

    def add_member(self, name, url):
        self.clients[name] = object()
        self.streams[name] = []
        self.rows[name] = {"instance": name, "up": True, "stale": False, "warming": True,
                           "healthy": True, "headroom": None, "time_to_saturation_s": None}
        self.added.append((name, url))

    def remove_member(self, name, cause=None):
        if self.fail_remove:
            raise RuntimeError("drain failed")
        moved = list(self.streams.pop(name, []))
        self.clients.pop(name)
        self.rows.pop(name)
        self.removed.append(name)
        return moved

    def streams_on(self, member):
        return list(self.streams.get(member, []))


def _spawner():
    n = {"i": 0}

    def spawn():
        name = f"a{n['i']}"
        n["i"] += 1
        return name, f"http://auto:{8000 + n['i']}"
    return spawn


def _bad_spawner():
    raise RuntimeError("no capacity to spawn")


# Each scenario: (members, supervisor kwargs, steps). A step is
# ("set", member, {fields}), ("advance", s), ("pass",), or ("fail_remove",).
SCENARIOS = {
    "forecast_spawn_then_cooldown": (("m0", "m1"), {}, [
        ("set", "m0", {"time_to_saturation_s": 500.0}),
        ("set", "m1", {"time_to_saturation_s": 80.0}), ("pass",),
        ("set", "a0", {"warming": False, "headroom": 0.9}), ("advance", 5.0), ("pass",),
        ("advance", 6.0), ("pass",)]),
    "min_bound_and_max_bound": (("m0",), {"min_members": 2, "max_members": 2}, [
        ("pass",), ("set", "a0", {"warming": False, "headroom": 0.5,
                                  "time_to_saturation_s": 5.0}),
        ("advance", 30.0), ("pass",)]),
    "warming_blocks_second_spawn": (("m0", "m1"), {}, [
        ("set", "m0", {"time_to_saturation_s": 10.0}), ("pass",), ("advance", 30.0),
        ("pass",)]),
    "flat_or_far_forecast_holds": (("m0", "m1"), {}, [
        ("pass",), ("set", "m0", {"time_to_saturation_s": 1e6}), ("pass",)]),
    "spawner_exception_contained": (("m0", "m1"), {"spawner": _bad_spawner}, [
        ("set", "m0", {"time_to_saturation_s": 10.0}), ("pass",), ("advance", 11.0),
        ("pass",)]),
    "device_fault_spawn": (("m0", "m1"), {}, [
        ("set", "m0", {"time_to_saturation_s": 10.0, "device_fault_failovers": 0}),
        ("pass",), ("set", "a0", {"warming": False, "headroom": 0.9}), ("advance", 5.0),
        ("set", "m0", {"time_to_saturation_s": None}), ("pass",),
        ("set", "m0", {"device_fault_failovers": 1}), ("pass",)]),
    "advisory_mode": (("m0", "m1"), {"spawner": None}, [
        ("set", "m0", {"time_to_saturation_s": 10.0}), ("pass",), ("advance", 20.0),
        ("pass",)]),
    "surplus_retires_the_emptiest": (("m0", "m1", "m2"), {}, [
        ("set", "m0", {"headroom": 0.9}), ("set", "m1", {"headroom": 0.95}),
        ("set", "m2", {"headroom": 0.92}), ("pass",), ("advance", 20.0), ("pass",),
        ("set", "m1", {"headroom": 0.1}), ("advance", 5.0), ("pass",),
        ("set", "m1", {"headroom": 0.95}), ("advance", 31.0), ("pass",), ("advance", 31.0),
        ("pass",), ("advance", 31.0), ("pass",)]),
    "unreported_capacity_holds_scale_in": (("m0", "m1", "m2"), {}, [
        ("set", "m0", {"headroom": None}), ("set", "m1", {"headroom": 0.9}),
        ("set", "m2", {"headroom": 0.9}), ("pass",), ("advance", 40.0), ("pass",)]),
    "drain_failure_keeps_the_member": (("m0", "m1", "m2"), {}, [
        ("set", "m0", {"headroom": 0.9}), ("set", "m1", {"headroom": 0.9}),
        ("set", "m2", {"headroom": 0.9}), ("fail_remove",), ("pass",), ("advance", 40.0),
        ("pass",)]),
    "symmetric_spawn_cooldown": (("m0", "m1", "m2"), {"retire_cooldown_s": 5.0}, [
        ("set", "m0", {"headroom": 0.9}), ("set", "m1", {"headroom": 0.9}),
        ("set", "m2", {"headroom": 0.9}), ("pass",), ("advance", 31.0), ("pass",),
        ("set", "m0", {"time_to_saturation_s": 30.0}), ("advance", 2.0), ("pass",),
        ("advance", 9.0), ("pass",)]),
}


def _run(pkg, name):
    members, kw, steps = SCENARIOS[name]
    kw = dict(kw)
    if "spawner" not in kw:
        kw["spawner"] = _spawner()
    router = FakeRouter(members)
    clock = FakeClock()
    kw.setdefault("min_members", 1)
    kw.setdefault("max_members", 4)
    sup = pkg.FleetSupervisor(router, clock=clock, sleep=lambda s: None,
                              spawn_horizon_s=120.0, surplus_headroom=0.6,
                              surplus_hold_s=30.0, spawn_cooldown_s=10.0,
                              **{"retire_cooldown_s": 30.0, **kw})
    decisions = []
    for step in steps:
        if step[0] == "set":
            router.rows[step[1]].update(step[2])
        elif step[0] == "advance":
            clock.t += step[1]
        elif step[0] == "fail_remove":
            router.fail_remove = True
        else:
            decisions.append(sup.run_pass())
    snap = sup.snapshot()
    return json.loads(json.dumps({"decisions": decisions, "events": list(sup.events),
                                  "snapshot": snap, "added": router.added,
                                  "removed": router.removed}, default=str))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_decisions_equal_jax(name):
    port, jax_ = _run(supervisor, name), _run(jsupervisor, name)
    assert port == jax_
    assert port["decisions"]


def test_supervisor_scenarios_reach_their_reasons():
    reasons = {name: [d.get("reason") for d in _run(supervisor, name)["decisions"]]
               for name in SCENARIOS}
    assert "saturation_forecast" in reasons["forecast_spawn_then_cooldown"]
    assert "min_bound" in reasons["min_bound_and_max_bound"]
    assert "device_fault" in reasons["device_fault_spawn"]
    actions = [d["action"] for d in _run(supervisor, "surplus_retires_the_emptiest")["decisions"]]
    assert "retire" in actions


def test_supervisor_families_equal_jax_and_lint_clean():
    for pkg in PKGS.values():
        pkg.FleetSupervisor(FakeRouter(), clock=FakeClock(), sleep=lambda s: None)

    # Registered families, children or not: a labelled family renders only
    # once a child exists, which other tests of a worker may have made in
    # one registry and not the other.
    def families(reg):
        return sorted(f.name for f in reg.families() if f.name.startswith("vep_supervisor_"))

    assert families(obs_registry) == families(jobs_registry)
    assert len(families(obs_registry)) >= 6
    assert not lint_exposition(obs_registry.render())


YAML = """
obs:
  trace: true
  instance: m7
  fleet_members: [m0=http://127.0.0.1:8080, m1=http://127.0.0.1:8081]
  fleet_scrape_s: 1.5
  fleet_stale_s: 4.0
engine:
  capacity: true
  capacity_fast_window_s: 5.0
  capacity_slow_window_s: 600.0
  capacity_util_objective: 0.7
  capacity_eval_interval_s: 0.5
router:
  members: [m0=http://127.0.0.1:8080]
  port: 9191
  scrape_interval_s: 0.5
  vnodes: 32
  max_moves_per_pass: 4
  min_healthy_age_s: 2.0
  drain_timeout_s: 3.0
  ema_alpha: 0.5
  healthy_above: 0.8
  unhealthy_below: 0.3
supervisor:
  enabled: true
  min_members: 2
  max_members: 5
  decision_interval_s: 1.0
  spawn_horizon_s: 60.0
  surplus_headroom: 0.5
  surplus_hold_s: 10.0
  spawn_cooldown_s: 12.0
  retire_cooldown_s: 40.0
"""


@pytest.mark.parametrize("source", ["defaults", "yaml"])
def test_config_sections_equal_jax(source, tmp_path):
    if source == "yaml":
        path = tmp_path / "conf.yaml"
        path.write_text(YAML)
        port, jax_ = config.load_config(str(path)), jconfig.load_config(str(path))
    else:
        port, jax_ = config.Config(), jconfig.Config()
    for section in ("obs", "router", "supervisor"):
        assert dataclasses.asdict(getattr(port, section)) == \
            dataclasses.asdict(getattr(jax_, section)), section
    cap = {f.name for f in dataclasses.fields(config.EngineConfig)
           if f.name.startswith("capacity")}
    assert cap == {f.name for f in dataclasses.fields(jconfig.EngineConfig)
                   if f.name.startswith("capacity")}
    assert {k: getattr(port.engine, k) for k in cap} == {k: getattr(jax_.engine, k)
                                                         for k in cap}


@pytest.mark.slow
def test_autoscale_soak_on_cpu_members_passes_the_jax_gates(tmp_path):
    """The autoscale soak with CPU members (two, then a third spawned from
    the prewarm manifest and one retired), each a process of its own,
    through tools/torch_autoscale_smoke.py's gates (about 2.5 minutes: the
    LoadShape runs 56 s, the retire waits out its 60 s cooldown)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_autoscale_smoke", os.path.join(root, "tools", "torch_autoscale_smoke.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from video_edge_ai_proxy_tpu_torch.replay.harness import LoadShape, run_autoscale_soak

    out = run_autoscale_soak(device="cpu", torch_threads=1, spawn_horizon_s=600.0,
                             shape=LoadShape(models=("", "tiny_mobilenet_v2")),
                             workdir=str(tmp_path))
    assert tool.autoscale_failures(out) == []

"""The port's fault plans (``video_edge_ai_proxy_tpu_torch/replay/faults.py``)
against the JAX package's: the same kinds and windows, the same plans as
JSON text for the same arguments, the same events due at the same times,
and the same refusals."""

import dataclasses

import pytest

from video_edge_ai_proxy_tpu.replay import faults as jfaults
from video_edge_ai_proxy_tpu_torch.replay import faults as tfaults

DEVICES = [f"fleet{i:02d}" for i in range(16)]


def test_kinds_and_windows_equal_jax():
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.RESILIENCE_KINDS == jfaults.RESILIENCE_KINDS
    assert tfaults.QUALITY_KINDS == jfaults.QUALITY_KINDS
    assert tfaults._RESILIENCE_WINDOWS == jfaults._RESILIENCE_WINDOWS
    assert tfaults._QUALITY_WINDOWS == jfaults._QUALITY_WINDOWS
    assert "shard_fault" in tfaults.KINDS


@pytest.mark.parametrize("devices", [DEVICES, ["cam1"], [], ["b", "a", "c"]],
                         ids=["16", "1", "0", "unsorted"])
@pytest.mark.parametrize("duration_s", [5.0, 20.0, 120.0])
def test_default_churn_equals_jax(devices, duration_s):
    assert tfaults.FaultPlan.default_churn(devices, duration_s).to_json() == \
        jfaults.FaultPlan.default_churn(devices, duration_s).to_json()


@pytest.mark.parametrize("kinds", [("uplink_down", "bus_flap", "device_stall"),
                                   ("uplink_down",), ("device_stall", "bus_flap")],
                         ids=lambda k: "+".join(k))
@pytest.mark.parametrize("duration_s", [3.0, 20.0, 120.0])
def test_resilience_plan_equals_jax(kinds, duration_s):
    assert tfaults.FaultPlan.resilience(duration_s, kinds).to_json() == \
        jfaults.FaultPlan.resilience(duration_s, kinds).to_json()


@pytest.mark.parametrize("kinds", [jfaults.QUALITY_KINDS, ("black_frame",),
                                   ("score_drift", "frozen_frame")], ids=lambda k: "+".join(k))
@pytest.mark.parametrize("devices", [DEVICES, ["only"]], ids=["16", "1"])
@pytest.mark.parametrize("duration_s", [3.0, 20.0])
def test_quality_plan_equals_jax(kinds, devices, duration_s):
    assert tfaults.FaultPlan.quality(duration_s, devices, kinds).to_json() == \
        jfaults.FaultPlan.quality(duration_s, devices, kinds).to_json()


def _raised(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["event", "resilience", "quality_kind", "quality_empty"])
def test_refusals_equal_jax(case):
    def run(mod):
        return {
            "event": lambda: mod.FaultEvent(at_s=1.0, kind="meteor"),
            "resilience": lambda: mod.FaultPlan.resilience(10.0, ("black_frame",)),
            "quality_kind": lambda: mod.FaultPlan.quality(10.0, DEVICES, ("bus_flap",)),
            "quality_empty": lambda: mod.FaultPlan.quality(10.0, []),
        }[case]
    assert _raised(run(tfaults)) == _raised(run(jfaults))


def test_pop_due_equals_jax():
    """The same events come due at the same times, once each, after reset
    again, and a plan read back from the JAX JSON gives the same text."""
    plans = [mod.FaultPlan(
        list(mod.FaultPlan.default_churn(DEVICES, 20.0).events)
        + list(mod.FaultPlan.resilience(20.0).events)
        + list(mod.FaultPlan.quality(20.0, DEVICES).events)) for mod in (tfaults, jfaults)]
    times = [0.0, 1.0, 2.0, 3.5, 5.0, 5.0, 7.9, 10.0, 12.4, 14.0, 17.0, 19.99, 25.0]
    for _ in range(2):
        for p in plans:
            p.reset()
        for t in times:
            got, want = (p.pop_due(t) for p in plans)
            assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    assert plans[0].pop_due(1e9) == []
    back = tfaults.FaultPlan.from_json(plans[1].to_json())
    assert back.to_json() == plans[1].to_json()
    assert [type(e).__module__ for e in back.events] == [tfaults.__name__] * len(back.events)


def test_events_sort_by_time_only():
    a = tfaults.FaultEvent(at_s=2.0, kind="bus_stall")
    b = tfaults.FaultEvent(at_s=1.0, kind="uplink_down", device_id="x", duration_s=3.0)
    assert sorted([a, b]) == [b, a]
    assert tfaults.FaultEvent(at_s=1.0, kind="bus_flap") == \
        tfaults.FaultEvent(at_s=1.0, kind="camera_kill", device_id="y")

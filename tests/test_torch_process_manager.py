"""The port's camera process manager, the counterparts of
``tests/test_serve.py::TestProcessManager``: each test spawns ``python -m
video_edge_ai_proxy_tpu_torch.ingest.worker`` on a tiny ``test://``
source, and every wait has a timeout of its own. The restart backoff and
its reset run on a supervisor pass driven with an injected clock."""

import hashlib
import os
import signal
import time

import pytest

from video_edge_ai_proxy_tpu.serve.process_manager import ProcessManager as JaxManager
from video_edge_ai_proxy_tpu_torch.bus import open_bus
from video_edge_ai_proxy_tpu_torch.serve import ProcessError, ProcessManager, Storage, StreamProcess
from video_edge_ai_proxy_tpu_torch.serve import process_manager as pmmod
from video_edge_ai_proxy_tpu_torch.serve.models import PREFIX_RTSP_PROCESS


def synth_url(frames=0):
    extra = f"&frames={frames}" if frames else ""
    return f"test://pattern?w=32&h=24&fps=30&gop=5{extra}"


def wait_for(cond, timeout=20.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except OSError:
        return True


@pytest.fixture()
def env(tmp_path, shm_dir):
    """(bus, storage, make) where make(**kw) builds a manager that the
    fixture closes, workers and all."""
    bus = open_bus("shm", shm_dir)
    storage = Storage(str(tmp_path / "reg.db"))
    made = []

    def make(**kw):
        m = ProcessManager(storage, bus, shm_dir=shm_dir, **kw)
        made.append(m)
        return m

    yield bus, storage, make
    for m in made:
        m.close()
    bus.close()
    storage.close()


def test_start_spawns_worker_and_publishes(env):
    bus, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    bus.touch_query("cam1")
    assert wait_for(lambda: bus.read_latest("cam1") is not None)
    record = manager.info("cam1")
    assert record.state.running and record.state.pid > 0
    assert record.container_id.startswith(f"{record.state.pid}@")
    with open(f"/proc/{record.state.pid}/cmdline", "rb") as fh:
        assert pmmod.WORKER_MODULE.encode() in fh.read().split(b"\0")
    manager.stop("cam1")
    assert manager.list() == [] and bus.read_latest("cam1") is None


def test_worker_resource_limits_applied(env):
    """RLIMIT_AS and nice of a spawned worker, read from /proc."""
    _, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    record = manager.info("cam1")
    assert record.limits == {"mem_limit_mb": pmmod.WORKER_MEM_LIMIT_MB,
                             "nice": pmmod.WORKER_NICE,
                             "log_tail_lines": pmmod.LOG_TAIL_LINES}
    pid = record.state.pid
    with open(f"/proc/{pid}/limits") as fh:
        line = next(ln for ln in fh if ln.startswith("Max address space"))
    assert line.split()[3:5] == [str(2048 << 20)] * 2
    with open(f"/proc/{pid}/stat") as fh:
        assert int(fh.read().rsplit(")", 1)[1].split()[16]) == pmmod.WORKER_NICE
    # The worker runs under its limit: it decodes and publishes.
    assert wait_for(lambda: (manager.info("cam1").heartbeat or {}).get("published", 0) > 0)


def test_duplicate_unknown_and_default_name(env):
    _, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    with pytest.raises(ProcessError):
        manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    with pytest.raises(ProcessError):
        manager.stop("ghost")
    with pytest.raises(ProcessError):
        manager.start(StreamProcess(name="x"))
    url = synth_url(frames=7)
    assert manager.start(StreamProcess(rtsp_endpoint=url)).name == \
        hashlib.md5(url.encode()).hexdigest()
    assert manager.device_ids() == sorted(["cam1", hashlib.md5(url.encode()).hexdigest()])


def test_restart_policy_always(env, monkeypatch):
    """A worker that exits (bounded by vep_max_frames) is respawned."""
    monkeypatch.setenv("vep_max_frames", "5")
    bus, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    bus.touch_query("cam1")
    pid1 = manager.info("cam1").state.pid
    assert wait_for(lambda: manager.info("cam1").state.failing_streak >= 1, timeout=30)
    assert wait_for(lambda: manager.info("cam1").state.running
                    and manager.info("cam1").state.pid != pid1, timeout=30)


class _FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.code = None

    def poll(self):
        return self.code


def test_backoff_grows_then_resets_after_stability(env, monkeypatch):
    """On a supervisor pass with the clock injected: each exit grows the
    decorrelated-jitter backoff (within RESTART_BACKOFF_MAX_S), no respawn
    before it is due, and a worker up STABLE_AFTER_S resets the streak, the
    backoff and the OOM flag."""
    _, storage, make = env
    manager = make()
    manager._stop.set()
    manager._supervisor.join(10)
    assert not manager._supervisor.is_alive()
    now = [1000.0]
    spawned = []

    def fake_spawn(record, entry):
        entry.proc = _FakeProc(100 + len(spawned))
        entry.last_spawn = now[0]
        spawned.append(record.name)

    monkeypatch.setattr(manager, "_spawn", fake_spawn)
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    entry = manager._entries["cam1"]
    backoffs = []
    for streak in range(1, 6):
        entry.proc.code = -signal.SIGKILL
        manager._supervise_once(now[0])
        assert entry.failing_streak == streak and entry.restarting
        backoffs.append(entry.backoff_s)
        assert pmmod.RESTART_BACKOFF_S <= entry.backoff_s <= pmmod.RESTART_BACKOFF_MAX_S
        manager._supervise_once(now[0] + entry.backoff_s - 0.01)
        assert len(spawned) == streak                  # not yet due
        now[0] += entry.backoff_s
        manager._supervise_once(now[0])
        assert len(spawned) == streak + 1 and not entry.restarting
    assert manager.info("cam1").state.oom_killed       # sticky across the restart
    assert max(backoffs) > pmmod.RESTART_BACKOFF_S
    manager._supervise_once(now[0] + manager.STABLE_AFTER_S - 1)
    assert entry.failing_streak == 5                   # not stable yet
    manager._supervise_once(now[0] + manager.STABLE_AFTER_S + 1)
    assert (entry.failing_streak, entry.backoff_s, entry.last_exit) == (0, 0.0, 0)
    assert not manager.info("cam1").state.oom_killed
    entry.proc.code = 1
    manager._supervise_once(now[0] + 100)
    assert entry.failing_streak == 1
    assert pmmod.RESTART_BACKOFF_S <= entry.backoff_s <= 3 * pmmod.RESTART_BACKOFF_S
    storage.delete(PREFIX_RTSP_PROCESS, "cam1")        # stopped meanwhile: no respawn
    manager._supervise_once(now[0] + 200)
    assert len(spawned) == 6 and not entry.restarting


def test_sigkill_exit_surfaces_oom_flag(env):
    _, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    assert wait_for(lambda: manager.info("cam1").state.running, timeout=30)
    os.kill(manager.info("cam1").state.pid, signal.SIGKILL)
    assert wait_for(lambda: manager.info("cam1").state.oom_killed, timeout=30)
    assert wait_for(lambda: manager.info("cam1").state.running, timeout=30)
    assert manager.info("cam1").state.failing_streak == 1


def test_eof_reconnect_forever_and_log_tail(env):
    """A source that runs dry reconnects instead of exiting; the log tail
    holds the worker's banner and grows with its reconnect lines."""
    bus, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url(frames=5)))
    assert wait_for(lambda: bus.read_latest("cam1") is not None)
    assert wait_for(lambda: any("ingest worker up" in ln
                                for ln in (manager.info("cam1").logs or {}).get("stdout", [])))
    first = manager.logs_since("cam1", 0)
    assert wait_for(lambda: manager.logs_since("cam1", first["total"])["lines"], timeout=20)
    record = manager.info("cam1")
    assert record.state.running and record.state.failing_streak == 0
    with pytest.raises(ProcessError):
        manager.logs_since("ghost", 0)


def test_registry_resume_respawns(env):
    _, _, make = env
    manager = make()
    manager.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url(),
                                inference_model="tiny_vit", annotation_policy="keyframe"))
    manager.shutdown_workers()
    second = make()
    assert second.resume() == 1
    assert wait_for(lambda: second.info("cam1").state.running)
    assert second.inference_model_of("cam1") == "tiny_vit"
    assert second.annotation_policy_of("cam1") == "keyframe"
    assert second.inference_model_of("ghost") == "" == second.annotation_policy_of("ghost")


def test_readoption_across_manager_restart(env, tmp_path):
    """Detach, then a new manager re-adopts the live worker (same pid and
    birth tick), frames keep flowing, its file log is followed, and stop()
    through the adopted handle kills it. The JAX package's manager does not
    claim the port's worker."""
    bus, storage, make = env
    log_dir = str(tmp_path / "wlogs")
    m1 = make(log_dir=log_dir)
    m1.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    bus.touch_query("cam1")
    assert wait_for(lambda: bus.read_latest("cam1") is not None)
    rec = m1.info("cam1")
    pid1, start1 = rec.state.pid, rec.runtime["starttime"]
    assert rec.runtime["pid"] == pid1 and start1
    assert m1._identify_worker(pid1, start1, "cam1") is not None
    jax_view = JaxManager.__new__(JaxManager)
    assert jax_view._identify_worker(pid1, start1, "cam1") is None
    m1.detach()
    assert not gone(pid1)
    m2 = make(log_dir=log_dir)
    assert m2.resume() == 1
    info = m2.info("cam1")
    assert info.state.running and info.state.pid == pid1
    assert m2.info("cam1").runtime["starttime"] == start1
    t_adopt = int(time.time() * 1000)
    bus.touch_query("cam1")
    assert wait_for(lambda: (f := bus.read_latest("cam1")) is not None
                    and f.meta.timestamp_ms >= t_adopt)
    assert wait_for(lambda: (m2.info("cam1").logs or {}).get("total", 0) > 0)
    m2.stop("cam1")
    assert wait_for(lambda: gone(pid1))


@pytest.mark.parametrize("change", ["contract", "adoption_off", "dead"])
def test_resume_respawns_what_it_must_not_adopt(env, tmp_path, change):
    """contract: the record changed while the server was down -> the live
    worker is killed and respawned; adoption_off: a manager without
    log_dir kills the survivor; dead: a worker that died meanwhile is
    respawned."""
    import json

    _, storage, make = env
    log_dir = str(tmp_path / "wlogs")
    m1 = make(log_dir=log_dir)
    m1.start(StreamProcess(name="cam1", rtsp_endpoint=synth_url()))
    pid1 = m1.info("cam1").state.pid
    m1.detach()
    if change == "contract":
        raw = json.loads(storage.get(PREFIX_RTSP_PROCESS, "cam1"))
        raw["rtsp_endpoint"] = synth_url(frames=99999)
        storage.put(PREFIX_RTSP_PROCESS, "cam1", json.dumps(raw).encode())
    elif change == "dead":
        os.kill(pid1, signal.SIGKILL)
        try:
            os.waitpid(pid1, 0)
        except ChildProcessError:
            pass
    m2 = make(log_dir="" if change == "adoption_off" else log_dir)
    assert m2.resume() == 1
    assert wait_for(lambda: m2.info("cam1").state.running)
    assert m2.info("cam1").state.pid != pid1
    assert wait_for(lambda: gone(pid1))

"""The port's registry, settings, cron and config against the JAX
package's: the sqlite registry and the ``StreamProcess`` JSON read both
ways, the schedule and duration parsers and the archive clean-up on the
same inputs, and ``load_config`` on one YAML file."""

import dataclasses
import os
import pathlib
import time

import pytest

from video_edge_ai_proxy_tpu.serve import cron as jax_cron
from video_edge_ai_proxy_tpu.serve import models as jax_models
from video_edge_ai_proxy_tpu.serve.settings import SettingsManager as JaxSettings
from video_edge_ai_proxy_tpu.serve.storage import Storage as JaxStorage
from video_edge_ai_proxy_tpu.utils import config as jax_config
from video_edge_ai_proxy_tpu.utils import parsing as jax_parsing
from video_edge_ai_proxy_tpu.utils import signing as jax_signing
from video_edge_ai_proxy_tpu_torch.serve import cron, models
from video_edge_ai_proxy_tpu_torch.serve.settings import SettingsManager
from video_edge_ai_proxy_tpu_torch.serve.storage import NotFound, Storage
from video_edge_ai_proxy_tpu_torch.utils import config, parsing, signing

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _record(mod):
    return mod.StreamProcess(
        name="cam1", image_tag="t", rtsp_endpoint="rtsp://10.0.0.2/s",
        rtmp_endpoint="rtmp://cloud/live/key9", container_id="42@host", status="running",
        state=mod.ProcessState(status="running", running=True, pid=42, failing_streak=2,
                               oom_killed=True),
        logs={"stdout": ["a", "b"], "total": 2}, created=1000, modified=2000,
        rtmp_stream_status=mod.RTMPStreamStatus(streaming=True, storing=False),
        inference_model="vit_b16", annotation_policy="keyframe",
        limits={"mem_limit_mb": 2048}, source="synthetic", heartbeat={"fps": 30},
        runtime={"pid": 42, "starttime": 77, "log_path": "/x/cam1.log"},
    )


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stream_process_json_both_ways(writer):
    mods = {"jax": jax_models, "torch": models}
    reader = "torch" if writer == "jax" else "jax"
    raw = _record(mods[writer]).to_json()
    assert raw == _record(mods[reader]).to_json()          # byte for byte
    back = mods[reader].StreamProcess.from_json(raw)
    assert back.to_json() == mods[writer].StreamProcess.from_json(raw).to_json()
    assert back.inference_model == "vit_b16" and back.runtime["starttime"] == 77
    empty = mods[writer].StreamProcess(name="c", rtsp_endpoint="x").to_json()
    assert mods[reader].StreamProcess.from_json(empty).to_json() == empty


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_registry_and_settings_read_by_the_other_package(tmp_path, writer):
    """One registry.db: records and edge credentials written by one
    package are read by the other."""
    path = str(tmp_path / "registry.db")
    (ws, wm, wset), (rs, rm, rset) = (
        ((JaxStorage, jax_models, JaxSettings), (Storage, models, SettingsManager))
        if writer == "jax" else
        ((Storage, models, SettingsManager), (JaxStorage, jax_models, JaxSettings)))
    w = ws(path)
    w.put(wm.PREFIX_RTSP_PROCESS, "cam1", _record(wm).to_json())
    w.put(wm.PREFIX_RTSP_PROCESS, "cam2", wm.StreamProcess(name="cam2").to_json())
    wset(w).overwrite("k1", "s1")
    w.close()
    r = rs(path)
    try:
        got = r.list(rm.PREFIX_RTSP_PROCESS)
        assert sorted(got) == ["cam1", "cam2"]
        # from_json keeps what the registry persists (not the transient
        # source and heartbeat), in both packages.
        want = rm.StreamProcess.from_json(_record(rm).to_json()).to_json()
        assert rm.StreamProcess.from_json(got["cam1"]).to_json() == want
        assert rset(r).edge_credentials() == ("k1", "s1")
        r.delete(rm.PREFIX_RTSP_PROCESS, "cam2")
        assert r.get_or_none(rm.PREFIX_RTSP_PROCESS, "cam2") is None
    finally:
        r.close()


def test_storage_semantics(tmp_path):
    s = Storage(str(tmp_path / "a" / "reg.db"))
    s.put("/p/", "k", b"v1")
    s.put("/p/", "k", b"v2")
    s.put("/q/", "k", b"other")
    assert s.get("/p/", "k") == b"v2" and s.list("/p/") == {"k": b"v2"}
    with pytest.raises(NotFound):
        s.get("/p/", "missing")
    s.close()
    s = Storage(str(tmp_path / "a" / "reg.db"))          # survives a reopen
    assert s.get("/q/", "k") == b"other"
    s.close()
    mgr = SettingsManager(Storage(":memory:"))
    assert mgr.edge_credentials() == ("", "") and mgr.get().created > 0


DURATIONS = ["5m", "1h30m", "90s", "250ms", "@every 5m", "1.5h", " 2m ", "bad", "5x", "", "m5"]


@pytest.mark.parametrize("spec", DURATIONS)
def test_parse_duration_equals_jax(spec):
    def run(fn):
        try:
            return fn(spec)
        except ValueError:
            return "ValueError"
    assert run(cron.parse_duration) == run(jax_cron.parse_duration)


SCHEDULES = ["@every 5m", "5m", "@daily", "@hourly", "@weekly", "0 3 * * *", "*/15 * * * *",
             "0 0 1 jan *", "30 2 * * mon-fri", "0 12 1,15 * *", "0 0 29 feb *", "? * * * sun",
             "0 0 * * 7", "61 * * * *", "nonsense", "0 0 31 4 *"]


@pytest.mark.parametrize("spec", SCHEDULES)
def test_parse_schedule_equals_jax(spec):
    base = 1_760_000_000.0

    def fires(fn):
        try:
            sched = fn(spec)
        except ValueError as exc:
            return type(exc).__name__
        out, t = [], base
        for _ in range(4):
            t = sched.next_after(t)
            out.append(t)
        return out
    assert fires(cron.parse_schedule) == fires(jax_cron.parse_schedule)


def test_cleanup_archive_equals_jax(tmp_path):
    now = time.time()

    def tree(root):
        for rel, age in [("a/old.mp4", 900), ("a/new.mp4", 10), ("b/old.npz", 400),
                         ("b/keep.txt", 9000), ("c/d/older.mp4", 301), ("c/d/young.npz", 299)]:
            p = root / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"x")
            os.utime(p, (now - age, now - age))
        return root

    left = {}
    for name, fn in (("torch", cron.cleanup_archive), ("jax", jax_cron.cleanup_archive)):
        root = tree(tmp_path / name)
        assert fn(str(root), 300.0, now=now) == 3
        left[name] = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    assert left["torch"] == left["jax"] == ["a/new.mp4", "b/keep.txt", "c/d/young.npz"]


def _shared(port_cfg, jax_cfg) -> dict:
    """Every field of the port's Config, with the JAX Config's value of it."""
    out = {}
    for f in dataclasses.fields(port_cfg):
        mine, theirs = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        out[f.name] = (_shared(mine, theirs) if dataclasses.is_dataclass(mine)
                       else (mine, theirs))
    return out


# Defaults that differ by design: the port's peak for MFU is resolved from
# the card's name (0 = resolve), the JAX package's is the v5e's constant.
DIFFERENT_DEFAULTS = {"peak_tflops": (0.0, 197.0)}


def _pairs_equal(tree: dict) -> None:
    for name, v in tree.items():
        if isinstance(v, dict):
            _pairs_equal(v)
        elif name in DIFFERENT_DEFAULTS:
            assert v == DIFFERENT_DEFAULTS[name], (name, v)
        else:
            assert v[0] == v[1], (name, v)


def test_load_config_equals_jax(tmp_path, monkeypatch):
    """The repository's example YAML with every section changed, through
    both loaders: each field the port has reads the same value; sections
    the port lacks are ignored. No file: the defaults, equal too."""
    text = (ROOT / "conf.yaml.example").read_text() + """
obs: {trace: true}
"""
    text = (text.replace("grpc_port: 50001", "grpc_port: 50011")
            .replace("worker_adoption: true", "worker_adoption: false")
            .replace("shm_dir: /dev/shm/vep_tpu", "shm_dir: /dev/shm/elsewhere")
            .replace("unacked_limit: 1000", "unacked_limit: 77")
            .replace("on_disk_clean_older_than: 5m", "on_disk_clean_older_than: 7m")
            .replace("model: yolov8n", "model: vit_b16")
            .replace("annotation_emit: on_change", "annotation_emit: all"))
    path = tmp_path / "conf.yaml"
    path.write_text(text)
    port_cfg, jax_cfg = config.load_config(str(path)), jax_config.load_config(str(path))
    _pairs_equal(_shared(port_cfg, jax_cfg))
    assert port_cfg.grpc_port == 50011 and port_cfg.worker_adoption is False
    assert port_cfg.bus.shm_dir == "/dev/shm/elsewhere" and port_cfg.annotation.unacked_limit == 77
    assert port_cfg.engine.model == "vit_b16" and port_cfg.engine.annotation_emit == "all"
    monkeypatch.setenv("VEP_TPU_CONF", str(tmp_path / "absent.yaml"))
    _pairs_equal(_shared(config.load_config(), jax_config.load_config()))
    bad = tmp_path / "list.yaml"
    bad.write_text("- 1\n")
    with pytest.raises(ValueError):
        config.load_config(str(bad))


@pytest.mark.parametrize("url", ["rtmp://h/live/key1", "rtmp://h/key", "rtmp://h/live/",
                                 "http://h/live/k", "rtsp://10.0.0.1:554/s"])
def test_parsing_and_signing_equal_jax(url):
    def key(fn):
        try:
            return fn(url)
        except ValueError:
            return "ValueError"
    assert key(parsing.parse_rtmp_key) == key(jax_parsing.parse_rtmp_key)
    assert parsing.default_device_id(url) == jax_parsing.default_device_id(url)
    body = [{"device_name": url, "confidence": 0.5}]
    assert signing.sign_request(body, "k", "s", now_ms=123) == \
        jax_signing.sign_request(body, "k", "s", now_ms=123)
    payload, headers = signing.sign_request(body, "k", "s")
    assert jax_signing.verify_signature(payload, headers, "s")

"""The port's structured logging (``utils/logging.py``) against the JAX
package's: the same records give equal JSON lines and tab lines with the
same context fields, the loggers carry the same names, the JSON switch
works alike from the environment, and the port's engine and worker log
under the context JAX's set (``stream=<id> seq=<packet>`` while a slot
emits or a packet is handled). Tolerance: none.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.utils import logging as jlog
from video_edge_ai_proxy_tpu_torch.utils import logging as tlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTEXTS = [(None, None), ("cam1", None), (None, 7), ("cam1", 42)]
EXTRAS = [{}, {"vep_actor": "ladder", "vep_subject": "ladder:engine", "vep_journal_seq": 12},
          {"vep_subject": "stream:cam1"}]


def record(level=logging.WARNING, msg="drain failed; continuing %s", args=("x",), exc=False,
           extra=None, name="vep_tpu.engine.runner"):
    exc_info = None
    if exc:
        try:
            raise ValueError("boom")
        except ValueError:
            exc_info = sys.exc_info()
    rec = logging.LogRecord(name, level, __file__, 10, msg, args, exc_info)
    rec.created = 1700000000.123456
    rec.msecs = 123.0
    for k, v in (extra or {}).items():
        setattr(rec, k, v)
    return rec


def formatted(mod, rec, ctx, formatter):
    token = mod.set_log_context(*ctx)
    try:
        for flt in ("ContextFilter", "_ContextFilter"):
            if hasattr(mod, flt):
                getattr(mod, flt)().filter(rec)
                break
        return formatter.format(rec)
    finally:
        mod.reset_log_context(token)


@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("extra", range(len(EXTRAS)))
@pytest.mark.parametrize("exc", [False, True], ids=["plain", "exc"])
def test_json_lines_equal(ctx, extra, exc):
    lines = [formatted(mod, record(exc=exc, extra=EXTRAS[extra]), ctx, mod.JsonFormatter())
             for mod in (tlog, jlog)]
    assert lines[0] == lines[1]
    out = json.loads(lines[0])
    assert out["logger"] == "vep_tpu.engine.runner" and out["ts"] == 1700000000.123
    if ctx == ("cam1", 42):
        assert out["ctx"] == "stream=cam1 seq=42"
    assert ("exc" in out) == exc


@pytest.mark.parametrize("ctx", CONTEXTS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_tab_lines_and_context_strings_equal(ctx):
    assert tlog._FORMAT == jlog._FORMAT
    fmt = logging.Formatter(tlog._FORMAT)
    lines = [formatted(mod, record(level=logging.INFO, msg="ingest worker up: %s"), ctx, fmt)
             for mod in (tlog, jlog)]
    assert lines[0] == lines[1]
    a, b = tlog.set_log_context(*ctx), jlog.set_log_context(*ctx)
    try:
        assert tlog._LOG_CTX.get() == jlog._LOG_CTX.get()
    finally:
        tlog.reset_log_context(a)
        jlog.reset_log_context(b)


def test_log_context_nests_and_resets_alike():
    seen = []
    for mod in (tlog, jlog):
        with mod.log_context(stream="a"):
            outer = mod._LOG_CTX.get()
            with mod.log_context(stream="b", seq=3):
                inner = mod._LOG_CTX.get()
            seen.append((outer, inner, mod._LOG_CTX.get()))
        seen.append(mod._LOG_CTX.get())
    assert seen[0:2] == seen[2:4]
    assert seen[0] == ("[stream=a]\t", "[stream=b seq=3]\t", "[stream=a]\t") and seen[1] == ""


def test_context_is_per_thread():
    got = {}

    def other():
        got["other"] = tlog._LOG_CTX.get()

    with tlog.log_context(stream="main", seq=1):
        th = threading.Thread(target=other)
        th.start()
        th.join()
        got["main"] = tlog._LOG_CTX.get()
    assert got == {"other": "", "main": "[stream=main seq=1]\t"}


@pytest.mark.parametrize("name", ["ingest.worker", "ingest.av", "ingest.archive",
                                  "ingest.passthrough", "bus.redis", "uplink.redis_queue"])
def test_logger_names_equal(name):
    assert tlog.get_logger(name).name == jlog.get_logger(name).name == f"vep_tpu.{name}"


def test_the_new_modules_log_under_the_jax_names():
    from video_edge_ai_proxy_tpu.bus import redis_bus as jredis
    from video_edge_ai_proxy_tpu.ingest import archive as jarchive
    from video_edge_ai_proxy_tpu.ingest import av as jav
    from video_edge_ai_proxy_tpu.ingest import passthrough as jpass
    from video_edge_ai_proxy_tpu.ingest import worker as jworker
    from video_edge_ai_proxy_tpu.uplink import redis_queue as jqueue
    from video_edge_ai_proxy_tpu_torch.bus import redis_bus
    from video_edge_ai_proxy_tpu_torch.ingest import archive, av, passthrough, worker
    from video_edge_ai_proxy_tpu_torch.uplink import redis_queue

    pairs = [(redis_bus, jredis), (archive, jarchive), (av, jav), (passthrough, jpass),
             (worker, jworker), (redis_queue, jqueue)]
    for port, jax_ in pairs:
        assert port.log.name == jax_.log.name, port.__name__


JSON_PROBE = """
import sys
mod = sys.argv[1]
logging_mod = __import__(mod + ".utils.logging", fromlist=["get_logger"])
log = logging_mod.get_logger("probe")
token = logging_mod.set_log_context(stream="cam9", seq=5)
log.warning("hello %d", 3, extra={"vep_actor": "engine", "vep_journal_seq": 4})
logging_mod.reset_log_context(token)
log.info("plain")
log.debug("hidden")
"""


def test_json_switch_from_the_environment_alike():
    outs = {}
    for mod in ("video_edge_ai_proxy_tpu_torch", "video_edge_ai_proxy_tpu"):
        env = dict(os.environ, PYTHONPATH=ROOT, VEP_TPU_LOG_JSON="1", VEP_TPU_LOG_LEVEL="INFO")
        proc = subprocess.run([sys.executable, "-c", JSON_PROBE, mod], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
        for line in lines:
            line.pop("ts")
        outs[mod] = lines
    assert outs["video_edge_ai_proxy_tpu_torch"] == outs["video_edge_ai_proxy_tpu"]
    assert outs["video_edge_ai_proxy_tpu"][0] == {
        "actor": "engine", "ctx": "stream=cam9 seq=5", "journal_seq": 4, "level": "WARNING",
        "logger": "vep_tpu.probe", "message": "hello 3"}
    assert len(outs["video_edge_ai_proxy_tpu"]) == 2


def test_enable_json_logs_swaps_the_formatter():
    tlog._configure()
    try:
        tlog.enable_json_logs(True)
        assert isinstance(tlog._handler.formatter, tlog.JsonFormatter)
        tlog.enable_json_logs(False)
        assert type(tlog._handler.formatter) is logging.Formatter
        assert tlog._handler.formatter._fmt == jlog._FORMAT
    finally:
        tlog.enable_json_logs(tlog._json_mode())


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.records = []

    def emit(self, rec):
        self.records.append(rec)


def test_engine_slot_records_carry_the_jax_context():
    """A record logged while a slot emits carries ``stream=<id>
    seq=<packet>`` (the string JAX's ``set_log_context`` makes for the same
    slot); the engine's "drain failed; continuing", logged after the slot's
    context is reset, carries none, as in JAX's engine."""
    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine import runner
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    bus = MemoryFrameBus()
    bus.create_stream("cam1", 64 * 64 * 3)
    eng = InferenceEngine(bus, EngineConfig(model="tiny_yolov8", tick_ms=5), device="cpu")
    calls = {"n": 0}

    def annotate(device_id, meta, detections, spec):
        calls["n"] += 1
        runner.log.warning("annotating %s", device_id)
        if calls["n"] == 2:
            raise RuntimeError("injected emit failure")

    eng._annotate = annotate
    keep = _Keep()
    runner.log.addHandler(keep)
    eng.start()
    try:
        sub = eng.subscribe(timeout=0.1)
        deadline = time.time() + 30
        packet = 0
        while calls["n"] < 3 and time.time() < deadline:
            packet += 1
            bus.publish("cam1", np.full((64, 64, 3), 128, np.uint8),
                        FrameMeta(width=64, height=64, packet=packet,
                                  timestamp_ms=int(time.time() * 1000)))
            try:
                next(sub)
            except StopIteration:
                pass
    finally:
        eng.stop()
        runner.log.removeHandler(keep)
    inside = [r for r in keep.records if r.getMessage() == "annotating cam1"]
    assert len(inside) >= 3
    for r in inside:
        seq = int(r.vep_ctx.split("seq=")[1].split("]")[0])
        token = jlog.set_log_context(stream="cam1", seq=seq)
        try:
            assert r.vep_ctx == jlog._LOG_CTX.get()
        finally:
            jlog.reset_log_context(token)
    drained = [r for r in keep.records if r.getMessage() == "drain failed; continuing"]
    assert len(drained) == 1 and drained[0].vep_ctx == ""


WORKER_LOG = """
from video_edge_ai_proxy_tpu_torch.ingest import worker
worker.main(["--max_frames", "3"])
"""


def test_worker_lines_carry_the_stream(shm_dir):
    env = dict(os.environ, PYTHONPATH=ROOT, device_id="logcam", vep_shm_dir=shm_dir,
               vep_bus_backend="shm",
               rtsp_endpoint="test://pattern?w=32&h=24&fps=30&gop=2&pace=0")
    proc = subprocess.run([sys.executable, "-c", WORKER_LOG], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    up = [line for line in proc.stdout.splitlines() if "ingest worker up" in line]
    down = [line for line in proc.stdout.splitlines() if "ingest worker down" in line]
    assert up and "\tvep_tpu.ingest.worker\t[stream=logcam]\t" in up[0]
    assert down and "[stream=logcam seq=2]" in down[0]

"""The port's end-to-end wire run (``video_edge_ai_proxy_tpu_torch/replay/harness.py``
``run_e2e``) against the JAX package's: a ``Server`` with a ``replay://``
worker subprocess on the shm bus, the engine and the gRPC ``Inference``
stream to a client thread, timed publish -> client-receive, on the CPU
with ``tiny_yolov8`` at 96x128. And the worker's ``replay://`` source loads
no torch: a worker runs under ``RLIMIT_AS`` and away from the card."""

import os
import subprocess
import sys

import pytest

from video_edge_ai_proxy_tpu.replay import harness as jharness
from video_edge_ai_proxy_tpu_torch.replay import harness as tharness
from video_edge_ai_proxy_tpu_torch.replay.recorder import record_synthetic_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_tracers():
    """The soak and the e2e run leave their span rings filled (the tools
    export them after the run); both packages' process-wide tracers get
    their config back and are emptied after each test, so the tests that
    follow in the same worker start from empty rings."""
    from video_edge_ai_proxy_tpu.obs import tracer as jtracer
    from video_edge_ai_proxy_tpu_torch.obs import tracer

    saved = [(t, t.enabled, t.sample_every) for t in (tracer, jtracer)]
    yield
    for t, enabled, every in saved:
        t.configure(enabled=enabled, sample_every=every)
        t.clear()

REPLAY_SOURCE = """
import sys
from video_edge_ai_proxy_tpu_torch.ingest.sources import open_source
src = open_source("replay://" + sys.argv[1] + "?device=cam0&pace=0")
src.open()
n = 0
for _ in range(3):
    n += src.grab() is not None and src.retrieve() is not None
src.close()
print(n, sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax")))
"""


def test_replay_source_loads_no_torch(tmp_path):
    trace = str(tmp_path / "w.vtrace")
    record_synthetic_trace(trace, ["cam0"], width=32, height=24, frames=3)
    proc = subprocess.run([sys.executable, "-c", REPLAY_SOURCE, trace], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == "3"
    assert proc.stdout.strip().endswith("[]"), proc.stdout


def _processes_with(text: str) -> list:
    """Pids of live processes whose environment holds ``text``."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as fh:
                if text.encode() in fh.read():
                    pids.append(int(pid))
        except OSError:
            pass
    return pids


def test_run_e2e_payload_equals_jax(tmp_path):
    """Both packages' run_e2e on the same geometry: results measured by the
    client through the wire, and the same payload keys (JAX's E2E
    artifact), its latency percentiles and its obs section. The port's run
    leaves no worker behind."""
    args = dict(duration_s=5.0, warmup_s=8.0, width=128, height=96, model="tiny_yolov8")
    jout = jharness.run_e2e(**args)
    workdir = tmp_path / "port_e2e"
    workdir.mkdir()
    tout = tharness.run_e2e(**args, workdir=str(workdir), device="cpu")
    assert _processes_with(str(workdir / "e2e.vtrace")) == []
    assert set(tout) == set(jout)
    assert set(tout["obs"]) == set(jout["obs"])
    assert set(tout["obs"]["trace"]) == set(jout["obs"]["trace"])
    for out in (jout, tout):
        assert out["results_measured"] > 0, out
        assert out["results_total"] >= out["results_measured"]
        assert set(out["latency_ms"]) == {"p50", "p90", "p95", "p99", "n"}
        assert out["latency_ms"]["n"] == out["results_measured"]
    for key in ("pipeline", "model", "src_hw", "fps", "duration_s", "warmup_s", "unit",
                "metric", "backend"):
        assert tout[key] == jout[key], key
    assert tout["metric"] == "e2e_single_path_latency_tiny_yolov8_cpu"
    assert tout["obs"]["perf"]["fps"] >= 0 and tout["obs"]["watch"] is not None
    assert not [d for d in os.listdir("/dev/shm") if d == f"vep_torch_e2e_{os.getpid()}"] \
        if os.path.isdir("/dev/shm") else True

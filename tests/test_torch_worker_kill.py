"""A SIGKILLed server's camera workers, in both packages: with
``worker_adoption`` off the workers must end with their server (the
parent-death signal, ``serve/process_manager.py`` ``_pdeathsig``: SIGTERM,
which the worker takes as a graceful stop, ``ingest/worker.py``).

Each case starts a server of one package in a process of its own (no
engine: the workers are the subject), starts one synthetic camera, prints
the worker's pid once its frames flow, and waits. The test SIGKILLs the
server process and checks that the worker is gone (or a zombie, reaped by
whoever inherits it) within ``EXIT_BOUND_S``.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The worker's graceful stop: its decode loop checks the stop flag once a
# frame (30 fps here), then closes its ring.
EXIT_BOUND_S = 10.0

PROBE = """
import sys, time
pkg = sys.argv[1]
if pkg == "jax":
    from video_edge_ai_proxy_tpu.serve import StreamProcess
    from video_edge_ai_proxy_tpu.serve.server import Server
    from video_edge_ai_proxy_tpu.utils.config import Config
else:
    from video_edge_ai_proxy_tpu_torch.serve import StreamProcess
    from video_edge_ai_proxy_tpu_torch.serve.server import Server
    from video_edge_ai_proxy_tpu_torch.utils.config import Config
cfg = Config()
cfg.bus.shm_dir = sys.argv[2]
cfg.worker_adoption = False
srv = Server(cfg, data_dir=sys.argv[3], grpc_port=0, rest_port=0)
srv.process_manager.start(StreamProcess(
    name="kill", rtsp_endpoint="test://pattern?w=32&h=24&fps=30&gop=5"))
deadline = time.time() + 60
while time.time() < deadline:
    recs = [r for r in srv.process_manager.list() if r.container_id]
    if recs:
        break
    time.sleep(0.05)
print("WORKER", recs[0].container_id.split("@")[0], flush=True)
time.sleep(600)
"""


def _alive(pid: int) -> bool:
    """Running, not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            state = fh.read().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return False
    return state != "Z"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sigkilled_server_takes_its_workers(pkg, tmp_path):
    shm = tempfile.mkdtemp(prefix="vep_kill_", dir="/dev/shm" if os.path.isdir("/dev/shm")
                           else None)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", PROBE, pkg, shm, str(tmp_path / "data")],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    worker = None
    try:
        line = ""
        while not line.startswith("WORKER "):   # the JAX server logs to stdout
            line = proc.stdout.readline()
            assert line, "the server exited before its worker started"
        worker = int(line.split()[1])
        assert _alive(worker)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(10)
        deadline = time.monotonic() + EXIT_BOUND_S
        while _alive(worker) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not _alive(worker), f"{pkg} worker {worker} outlived its SIGKILLed server"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        if worker is not None and _alive(worker):
            os.kill(worker, signal.SIGKILL)
        import shutil

        shutil.rmtree(shm, ignore_errors=True)

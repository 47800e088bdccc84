"""The server's card-side planes on the card: a ``Server`` with its engine
on the GPU (``tiny_yolov8``), driven in ``start()``'s order without the
wire (registry resume, cron, the annotation consumer, the engine), one
``test://`` camera through the process manager, one subscriber: results
with track ids, annotation events on the queue, then ``stop()``.

Marked ``cuda``: skips without a GPU (decided inside the fixture). Run it
on a machine with a card with
    python -m pytest tests/test_torch_cuda_server.py -m cuda -q
This file imports torch, numpy and the port only (no ``grpc``, no JAX).
"""

import shutil
import tempfile
import threading
import time

import pytest
import torch

from video_edge_ai_proxy_tpu_torch.proto import annotate
from video_edge_ai_proxy_tpu_torch.replay.checksum import zero_class_prior
from video_edge_ai_proxy_tpu_torch.serve import StreamProcess
from video_edge_ai_proxy_tpu_torch.serve.server import Server
from video_edge_ai_proxy_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from video_edge_ai_proxy_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


def test_server_planes_serve_a_camera_on_the_card(card, tmp_path):
    rings = tempfile.mkdtemp(prefix="vep_cuda_srv_")
    cfg = Config()
    cfg.bus.shm_dir = rings
    cfg.annotation.endpoint = "http://127.0.0.1:1/annotate"   # refused at once
    cfg.worker_adoption = False
    cfg.engine.model = "tiny_yolov8"
    cfg.engine.batch_buckets = (1, 2)
    srv = Server(cfg, data_dir=str(tmp_path), enable_engine=True, device="cuda")
    queued = []
    publish = srv.annotations.publish
    srv.annotations.publish = lambda payload: queued.append(payload) or publish(payload)
    try:
        srv.engine.warmup()
        srv.engine._model.load_state_dict(zero_class_prior(srv.engine._model.state_dict()))
        srv.process_manager.resume()
        srv.cron.start()
        srv.annotations.start()
        srv.engine.start()
        srv.process_manager.start(StreamProcess(
            name="cam0", rtsp_endpoint="test://pattern?w=160&h=120&fps=30&gop=30"))
        got = []
        results = srv.engine.subscribe(["cam0"], timeout=0.1)
        reader = threading.Thread(target=lambda: got.extend(results), daemon=True)
        reader.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and (len(got) < 10 or not queued):
            time.sleep(0.1)
    finally:
        srv.stop()
        shutil.rmtree(rings, ignore_errors=True)
    reader.join(10)
    assert len(got) >= 10 and {r.model for r in got} == {"tiny_yolov8"}
    dets = [d for r in got for d in r.detections]
    assert dets and all(d.track_id for d in dets)
    events = [annotate.decode(b) for b in queued]
    assert events and {e.device_name for e in events} == {"cam0"}
    assert all(e.type == "detection" and e.object_bouding_box is not None for e in events)
    assert srv.engine._steps and all(k[0] == "tiny_yolov8" for k in srv.engine._steps)

"""The port's self-training loop end to end on the CPU: the twin of
``tests/test_selftrain_e2e.py`` through ``tools/torch_selftrain_e2e.py``.

The same chain (the port's archiver -> the loader's label join -> the
ultralytics-layout import through ``tools/torch_import_weights.py`` -> the
fine-tune with BatchNorm statistics -> held-out mAP through the serving
program -> the calibrated threshold in the checkpoint's metadata -> the
engine serving the checkpoint) at the JAX twin's settings: ``tiny_yolov8``
at 64 px, 250 steps, the easy synthetic site. The assertions are the JAX
twin's: the chain closes and learning is real (post > pre on held-out
data). The port's run takes about 40-50 s on an idle machine, but 303 s
of a tier-1 run beside five other test workers, so it is marked slow, as
JAX's twin is (about 3 minutes): the tier-1 gate runs ``-m 'not slow'``
and the chain runs with ``-m slow``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import torch_selftrain_e2e as st  # noqa: E402

pytestmark = pytest.mark.slow


def _chain(workdir: str) -> dict:
    """One full run on 2 intra-op threads (restored after): at 64 px a
    step's convolutions are too small to gain from more, and on a loaded
    machine more threads spin (the run took 7 minutes at 8 threads beside
    other work, 40 s at 2)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        return st.run(
            "tiny_yolov8", steps=250, batch_size=8, n_cameras=1, segments_per_camera=4,
            frames_per_segment=16, learning_rate=3e-3, val_images=12, workdir=workdir,
            obj_frac=(0.3, 0.5), noise=4.0, seed=3, engine_leg=True, log=lambda *_: None,
            device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_chain_closes_and_learns(tmp_path):
    """One test, so that one test worker runs the chain (a module fixture
    runs once in every worker that takes one of its tests). In order: the
    artifacts; the loss falls; held-out mAP improves (the point of the
    loop); the engine serves the tuned checkpoint at least as well on
    recall (here, beside other test workers, its ladder may shed a late
    frame, as JAX's twin allows; the card's run gates every image); the
    operating point is stamped into the checkpoint and the engine serves at
    it; each serving leg counts its batches (what the card's run holds the
    keep-mask launches against: 12 images in buckets of 8 make 2 eval
    batches, and the engine drains at least one batch an image it
    serves)."""
    from video_edge_ai_proxy_tpu_torch.utils.checkpoint import load_msgpack_meta

    chain = _chain(str(tmp_path))
    assert chain["archived_segments"] == 4
    assert chain["train_frames"] == 64
    assert chain["steps"] == 250
    assert os.path.exists(chain["checkpoint"])
    assert np.isfinite(chain["first_loss"]) and np.isfinite(chain["last_loss"])
    assert (chain["chip"], chain["backend"]) == ("cpu", "cpu")

    assert chain["last_loss"] < chain["first_loss"]

    assert chain["post"]["mAP50"] > chain["pre"]["mAP50"]
    assert chain["post"]["mAP"] >= chain["pre"]["mAP"]

    assert chain["engine_post"]["images_served"] > 0
    assert chain["engine_post"]["recall"] >= chain["engine_pre"]["recall"]

    cal = chain["calibration"]
    assert 0.25 <= cal["conf_threshold"] <= 0.95
    assert cal["policy"] in ("max_f1_with_precision_floor", "max_precision")
    meta = load_msgpack_meta(chain["checkpoint"])
    assert meta["conf_threshold"] == cal["conf_threshold"]
    assert meta["calibration_images"] == 12
    assert chain["engine_post"]["conf_threshold"] == cal["conf_threshold"]
    assert chain["engine_pre"]["conf_threshold"] == 0.0
    if cal["policy"] == "max_f1_with_precision_floor":
        assert chain["engine_post"]["precision"] >= 0.4

    assert chain["eval_batches"] == {"pre": 2, "post": 2, "calibrate": 2}
    for leg in ("engine_pre", "engine_post"):
        assert chain[leg]["batches"] >= chain[leg]["images_served"] > 0

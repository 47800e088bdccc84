"""The self-training loop through the port, end to end, as one recorded run
(the port's counterpart of ``tools/selftrain_e2e.py``: the same steps,
flags and record keys).

    synthetic site footage (known ground truth)
      -> the port's archiver (``ingest/archive.py`` GOP segments on disk)
      -> the training bridge (``data/segments.py`` Loader, with_meta join)
      -> an imported init (the port's seeded init written in ultralytics
         layout, through ``tools/torch_import_weights.py``)
      -> the fine-tune (``parallel/train.py`` + ``models/detect_loss.py``,
         BatchNorm statistics updated, bf16 compute over float32 weights)
      -> held-out mAP before and after (``tools/torch_eval_detector.py``:
         the exact serving program, the keep-mask kernel on the card)
      -> the calibrated serving threshold, stamped into the checkpoint's
         metadata (``utils/checkpoint.py`` ``set_msgpack_meta``)
      -> engine serve-back (``InferenceEngine`` with ``checkpoint_path``:
         frames on the bus, detections out the subscriber fan-out)

Footage is synthesized and the "imported" init is a seeded random state
dict in the canonical ultralytics layout, so the import plumbing runs for
real and ground truth is exact: the pre/post mAP delta measures learning.

    python tools/torch_selftrain_e2e.py --model yolov8n --steps 600 --lr 3e-3 \\
        --val-images 120

``--device cuda`` (default) runs on the card and fails without one;
``--device cpu`` runs the CPU twin (``tests/test_torch_selftrain_e2e.py``).
The exit code is 1 unless post mAP50 > pre mAP50.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ------------------------------------------------------------ footage ----

# BGR colors per synthetic class: red box / green ellipse / blue triangle.
_CLASS_COLORS = ((40, 60, 220), (60, 200, 60), (220, 120, 40))


def synth_sequence(rng: np.random.Generator, n_frames: int, hw, n_obj: int,
                   obj_frac=(0.125, 0.334), noise: float = 8.0):
    """One camera GOP: a textured background, ``n_obj`` shapes moving
    linearly (bouncing at the edges). Returns (frames [T, H, W, 3] u8 BGR,
    per-frame list of (boxes xyxy px, classes)). ``obj_frac`` bounds the
    object size as a fraction of the frame (the task-difficulty dial).
    The draws are the JAX tool's, so one seed gives both tools the same
    footage."""
    h, w = hw
    base = int(rng.integers(30, 90))
    objs = []
    for _ in range(n_obj):
        ow = int(rng.integers(max(8, int(w * obj_frac[0])), max(9, int(w * obj_frac[1]))))
        oh = int(rng.integers(max(8, int(h * obj_frac[0])), max(9, int(h * obj_frac[1]))))
        objs.append({
            "wh": (ow, oh),
            "xy": np.array([rng.uniform(0, w - ow), rng.uniform(0, h - oh)]),
            "v": rng.uniform(-3, 3, 2),
            "cls": int(rng.integers(0, len(_CLASS_COLORS))),
        })
    frames, labels = [], []
    for _ in range(n_frames):
        img = np.full((h, w, 3), base, np.uint8)
        img = (img + rng.normal(0, noise, img.shape)).clip(0, 255).astype(np.uint8)
        boxes, classes = [], []
        for o in objs:
            ow, oh = o["wh"]
            o["xy"] += o["v"]
            for d, lim in ((0, w - ow), (1, h - oh)):
                if o["xy"][d] < 0 or o["xy"][d] > lim:
                    o["v"][d] *= -1
                    o["xy"][d] = np.clip(o["xy"][d], 0, lim)
            x, y = int(o["xy"][0]), int(o["xy"][1])
            color = _CLASS_COLORS[o["cls"]]
            region = img[y:y + oh, x:x + ow]
            if o["cls"] == 0:
                region[:] = color
            elif o["cls"] == 1:
                yy, xx = np.mgrid[0:oh, 0:ow]
                mask = (((yy - oh / 2) / (oh / 2)) ** 2 + ((xx - ow / 2) / (ow / 2)) ** 2) <= 1
                region[mask] = color
            else:
                yy, xx = np.mgrid[0:oh, 0:ow]
                region[xx * oh >= yy * ow] = color
            boxes.append([x, y, x + ow, y + oh])
            classes.append(o["cls"])
        frames.append(img)
        labels.append((np.array(boxes, np.float32), np.array(classes, np.int32)))
    return np.stack(frames), labels


def build_archive(root: str, rng: np.random.Generator, *, n_cameras: int,
                  segments_per_camera: int, frames_per_segment: int, hw, max_objects: int,
                  obj_frac=(0.125, 0.334), noise: float = 8.0):
    """Write footage through the port's archiver and return the label join
    {(device_id, start_ms, frame_idx): (boxes_px, classes)} in source pixel
    space (``data.SampleMeta`` keys)."""
    from video_edge_ai_proxy_tpu_torch.ingest.archive import GopSegment, SegmentArchiver

    arch = SegmentArchiver(root)
    arch.start()
    labels = {}
    for cam in range(n_cameras):
        device_id = f"synthcam{cam}"
        for s in range(segments_per_camera):
            start_ms = 10_000 * s
            frames, per_frame = synth_sequence(
                rng, frames_per_segment, hw, n_obj=int(rng.integers(1, max_objects + 1)),
                obj_frac=obj_frac, noise=noise)
            arch.submit(GopSegment(
                device_id=device_id, start_ts_ms=start_ms,
                end_ts_ms=start_ms + int(frames_per_segment * 1000 / 30),
                fps=30.0, frames=list(frames)))
            for i, lab in enumerate(per_frame):
                labels[(device_id, start_ms, i)] = lab
    arch.stop()
    if arch.written != n_cameras * segments_per_camera:
        raise RuntimeError(f"archiver wrote {arch.written} of "
                           f"{n_cameras * segments_per_camera} segments")
    return labels


def synth_val_set(rng: np.random.Generator, n_images: int, hw, max_objects: int,
                  max_boxes: int, obj_frac=(0.125, 0.334), noise: float = 8.0):
    """A held-out eval set in ``tools/torch_eval_detector.py`` layout (boxes
    and classes padded with -1), from fresh draws."""
    images, boxes, classes = [], [], []
    for _ in range(n_images):
        frames, labs = synth_sequence(rng, 1, hw, n_obj=int(rng.integers(1, max_objects + 1)),
                                      obj_frac=obj_frac, noise=noise)
        b, c = labs[0]
        k = min(len(c), max_boxes)
        pb_ = np.full((max_boxes, 4), -1, np.float32)
        pc_ = np.full((max_boxes,), -1, np.int64)
        pb_[:k] = b[:k]
        pc_[:k] = c[:k]
        images.append(frames[0])
        boxes.append(pb_)
        classes.append(pc_)
    return np.stack(images), np.stack(boxes), np.stack(classes)


# ------------------------------------------------ imported init leg ----

def fabricate_imported_init(model_name: str, seed: int, out_dir: str) -> str:
    """The port's seeded init -> an ultralytics-layout state dict (npz, the
    port importer's key map inverted) -> the importer CLI -> msgpack. A
    stand-in for a published checkpoint without network: the layout, the
    strict accounting and the stem refit run for real."""
    import torch

    from tools import torch_import_weights as iw_cli
    from video_edge_ai_proxy_tpu_torch.models import import_weights as iw
    from video_edge_ai_proxy_tpu_torch.models import registry

    model = registry.get(model_name).init_params(torch.Generator().manual_seed(seed),
                                                 device="cpu", dtype=torch.float32)
    state = {}
    for name, t in model.state_dict().items():
        if name.endswith(".num_batches_tracked"):
            continue
        state[f"model.{iw._yolo_key(iw._flax_path(name))}"] = t.float().numpy()
    # Published checkpoints ship a 3-channel stem; the serving config may
    # pad it (stem_pad_c): slice back so the importer's refit is under test.
    stem = "model.0.conv.weight"
    if state[stem].shape[1] > 3:
        state[stem] = state[stem][:, :3]
    src = os.path.join(out_dir, "published_layout.npz")
    np.savez(src, **state)
    out = os.path.join(out_dir, f"{model_name}_imported.msgpack")
    if iw_cli.main(["--model", model_name, "--src", src, "--out", out]) != 0:
        raise RuntimeError("torch_import_weights failed")
    return out


# ------------------------------------------------------- fine-tune ----

def finetune(model_name: str, archive_root: str, labels: dict, *, init_ckpt: str, steps: int,
             batch_size: int, max_boxes: int, learning_rate: float, out_ckpt: str,
             augment: bool = False, log_every: int = 25, log=print,
             device: str = "cuda", seed: int = 2) -> dict:
    """Fine-tune from the imported checkpoint on archived footage with the
    ``with_meta`` label join, BatchNorm statistics updated (``mutable_aux``;
    the init is random through the importer, so frozen statistics would
    degenerate deep features) and the gradients' global norm clipped at 10
    (the TAL/BCE loss starts in the hundreds on fresh heads). Saves the
    tuned checkpoint (float32 msgpack). Returns {"steps", "first_loss",
    "last_loss", "train_s", "step_ms_p50", "peak_reserved_bytes"}."""
    import torch

    from video_edge_ai_proxy_tpu_torch import parallel
    from video_edge_ai_proxy_tpu_torch.data import Loader, SegmentDataset
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import to_flax
    from video_edge_ai_proxy_tpu_torch.models.detect_loss import make_detection_loss_fn
    from video_edge_ai_proxy_tpu_torch.utils.checkpoint import load_msgpack, save_msgpack

    spec = registry.get(model_name)
    model = spec.init_params(device=device, param_dtype=torch.float32)
    cfg = model.cfg
    size = spec.input_size
    trainer = parallel.make_trainer(
        model, device, learning_rate=learning_rate, clip_norm=10.0,
        loss_fn=make_detection_loss_fn(cfg, update_stats=True), mutable_aux=True)
    state = trainer.init_state_from(load_msgpack(init_ckpt))
    dev = trainer.device
    cuda = dev.type == "cuda"

    ds = SegmentDataset(archive_root, size=(size, size), seed=1)
    if not len(ds):
        raise RuntimeError(f"no archived segments under {archive_root}")

    def targets_for(metas):
        b = np.zeros((len(metas), max_boxes, 4), np.float32)
        lab = np.zeros((len(metas), max_boxes), np.int64)
        m = np.zeros((len(metas), max_boxes), bool)
        for i, meta in enumerate(metas):
            key = (meta.device_id, meta.start_ms, meta.frame_idx)
            if key not in labels:
                continue  # an unlabeled frame trains as background
            boxes_px, classes = labels[key]
            # source px -> training space (SegmentDataset resizes
            # anisotropically to size x size)
            src = _source_hw(ds, meta.device_id)
            sx, sy = size / src[1], size / src[0]
            k = min(len(classes), max_boxes)
            b[i, :k] = boxes_px[:k] * [sx, sy, sx, sy]
            lab[i, :k] = classes[:k]
            m[i, :k] = True
        return {"boxes": torch.from_numpy(b).to(dev), "labels": torch.from_numpy(lab).to(dev),
                "mask": torch.from_numpy(m).to(dev)}

    gen = torch.Generator().manual_seed(seed)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    first_loss = last_loss = None
    step_s = []
    step_count = 0
    while step_count < steps:
        epoch_start = step_count
        for batch, metas in Loader(ds, batch_size=batch_size, with_meta=True):
            t_step = time.perf_counter()
            # The serving input convention: archived frames are BGR u8, the
            # letterbox serves RGB in [0, 1]. Training in BGR while serving
            # RGB silently zeroes held-out accuracy.
            x = torch.from_numpy(np.ascontiguousarray(batch[..., ::-1])).to(dev).float() / 255.0
            t = targets_for(metas)
            if augment:
                from video_edge_ai_proxy_tpu_torch.ops.augment import augment_detection_batch

                x, ab, am, al = augment_detection_batch(gen, x, t["boxes"], t["mask"],
                                                        t["labels"])
                t = {"boxes": ab, "mask": am, "labels": al}
            state, loss = trainer.train_step(state, x.permute(0, 3, 1, 2), t)
            loss_v = float(loss)
            step_s.append(time.perf_counter() - t_step)
            step_count += 1
            if first_loss is None:
                first_loss = loss_v
            if step_count % log_every == 0:
                log(f"  step {step_count}/{steps}: loss {loss_v:.3f}")
            if step_count >= steps:
                last_loss = loss_v
                break
        if step_count == epoch_start:
            # no full batch this epoch: looping again would re-decode the
            # archive forever
            raise RuntimeError(f"archive yields no full batch of {batch_size}; lower --batch "
                               "or archive more footage")
    train_s = time.monotonic() - t0
    save_msgpack(out_ckpt, to_flax(model.state_dict()))
    return {"steps": step_count, "first_loss": first_loss, "last_loss": last_loss,
            "train_s": round(train_s, 2),
            "step_ms_p50": 1000.0 * statistics.median(step_s),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev) if cuda else None}


def _source_hw(ds, device_id):
    """Source (h, w) per device, cached on the dataset (read from one of
    its segments)."""
    cache = getattr(ds, "_src_hw_cache", None)
    if cache is None:
        cache = {}
        ds._src_hw_cache = cache
    if device_id not in cache:
        from video_edge_ai_proxy_tpu_torch.data import read_segment

        ref = next(r for r in ds.refs if r.device_id == device_id)
        cache[device_id] = read_segment(ref).shape[1:3]
    return cache[device_id]


# ------------------------------------------------- engine serve-back ----

def _device_batches(model_name: str) -> int:
    """Detector batches the engines of this process have drained so far
    (``vep_device_batch_ms``'s count for the model)."""
    from video_edge_ai_proxy_tpu_torch.obs import registry as obs_registry

    hist = {f.name: f for f in obs_registry.families()}["vep_device_batch_ms"]
    return hist.labels(model_name).count


def engine_serve_metrics(model_name: str, ckpt: str, images: np.ndarray,
                         gt_boxes: np.ndarray, gt_classes: np.ndarray, *,
                         conf: float = 0.25, iou_thr: float = 0.5, deadline_s: float = 300.0,
                         device: str = "cuda") -> dict:
    """Serve ``ckpt`` through the engine loop (frames published on the bus,
    results read off the subscriber fan-out) and score the detections
    against ground truth. Returns {"recall", "precision", "images_served",
    "batches" (device batches drained after ``start()``), "conf_threshold"
    (the engine's serving threshold)}."""
    import queue
    import threading

    from video_edge_ai_proxy_tpu_torch.bus.interface import FrameMeta
    from video_edge_ai_proxy_tpu_torch.bus.memory_bus import MemoryFrameBus
    from video_edge_ai_proxy_tpu_torch.engine.runner import InferenceEngine
    from video_edge_ai_proxy_tpu_torch.utils.config import EngineConfig

    h, w = images.shape[1:3]
    bus = MemoryFrameBus()
    # Every bucket of the held-out geometry is prewarmed: on the card its
    # graph is captured at start(), not inside the first batch that meets it.
    buckets = (1, 2, 4)
    eng = InferenceEngine(bus, EngineConfig(
        model=model_name, batch_buckets=buckets, tick_ms=5, checkpoint_path=ckpt,
        prewarm=[[h, w, b] for b in buckets]), device=device)
    results: "queue.Queue" = queue.Queue()
    sub = eng.subscribe()

    def pump():
        for res in sub:
            results.put(res)

    eng.start()
    base = _device_batches(model_name)
    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    got = {}
    published = set()
    try:
        deadline = time.monotonic() + deadline_s
        i = 0
        while len(got) < len(images) and time.monotonic() < deadline:
            # one stream per held-out image: publish, await its result
            if i not in published:
                bus.create_stream(f"valcam{i}", w * h * 3)
                bus.publish(f"valcam{i}", images[i], FrameMeta(
                    width=w, height=h, channels=3, timestamp_ms=int(time.time() * 1000),
                    is_keyframe=True))
                published.add(i)
            try:
                res = results.get(timeout=2.0)
            except queue.Empty:
                # result lost or suppressed: move on rather than wedge
                i = min(i + 1, len(images) - 1)
                continue
            idx = int(res.device_id[len("valcam"):])
            got.setdefault(idx, res)
            if idx == i:
                i = min(i + 1, len(images) - 1)
        batches = _device_batches(model_name) - base
    finally:
        eng.stop()
        bus.close()
        pumper.join(timeout=10.0)

    tp = fp = n_gt = 0
    for idx, res in got.items():
        gt_keep = gt_classes[idx] >= 0
        gts = gt_boxes[idx][gt_keep]
        gcs = gt_classes[idx][gt_keep]
        n_gt += len(gts)
        matched = np.zeros(len(gts), bool)
        for det in res.detections:
            if det.confidence < conf or det.box is None:
                continue
            b = np.array([det.box.left, det.box.top, det.box.left + det.box.width,
                          det.box.top + det.box.height])
            best, best_iou = -1, iou_thr
            for gi, (gb, gc) in enumerate(zip(gts, gcs)):
                if matched[gi] or det.class_id != gc:
                    continue
                iou = _iou(b, gb)
                if iou >= best_iou:
                    best, best_iou = gi, iou
            if best >= 0:
                matched[best] = True
                tp += 1
            else:
                fp += 1
    return {
        "recall": round(tp / n_gt, 4) if n_gt else 0.0,
        "precision": round(tp / (tp + fp), 4) if tp + fp else 0.0,
        "images_served": len(got),
        "batches": batches,
        "conf_threshold": eng._conf_threshold,
    }


def _iou(a, b):
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[0] * wh[1]
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


# ------------------------------------------------------------ driver ----

def run(model_name: str = "yolov8n", *, steps: int = 300, batch_size: int = 8,
        n_cameras: int = 2, segments_per_camera: int = 6, frames_per_segment: int = 24,
        source_hw=None, max_objects: int = 3, max_boxes: int = 8,
        learning_rate: float = 1e-3, val_images: int = 32, obj_frac=(0.125, 0.334),
        noise: float = 8.0, augment: bool = False, workdir: str = "", seed: int = 0,
        engine_leg: bool = True, log=print, device: str = "cuda", leg=None) -> dict:
    """The whole chain; returns the record dict (the JAX tool's keys, plus
    the step time, the peak memory and each serving leg's batches).
    ``leg(name)``, when given, is a context manager entered around each
    serving leg (``eval_pre``, ``eval_post``, ``calibrate``,
    ``engine_pre``, ``engine_post``): how a caller counts kernel launches
    per leg."""
    import torch

    from tools import torch_eval_detector as eval_detector
    from video_edge_ai_proxy_tpu_torch.device import resolve_device
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.utils.checkpoint import set_msgpack_meta

    dev = resolve_device(device)
    leg = leg or (lambda name: contextlib.nullcontext())
    t_start = time.monotonic()
    workdir = workdir or tempfile.mkdtemp(prefix="selftrain_")
    os.makedirs(workdir, exist_ok=True)
    spec = registry.get(model_name)
    source_hw = tuple(source_hw or (spec.input_size, spec.input_size))
    rng = np.random.default_rng(seed)

    log(f"[1/6] archiving synthetic footage under {workdir}/archive ...")
    archive_root = os.path.join(workdir, "archive")
    if os.path.isdir(archive_root):
        # a stale archive would double the dataset and orphan half of it
        # from this run's label join
        import shutil

        shutil.rmtree(archive_root)
    labels = build_archive(
        archive_root, rng, n_cameras=n_cameras, segments_per_camera=segments_per_camera,
        frames_per_segment=frames_per_segment, hw=source_hw, max_objects=max_objects,
        obj_frac=obj_frac, noise=noise)
    n_train = n_cameras * segments_per_camera * frames_per_segment

    log("[2/6] importing the init checkpoint (ultralytics layout) ...")
    init_ckpt = fabricate_imported_init(model_name, seed + 1, workdir)

    log(f"[3/6] held-out val set ({val_images} images) ...")
    images, vboxes, vclasses = synth_val_set(rng, val_images, source_hw, max_objects,
                                             max_boxes, obj_frac=obj_frac, noise=noise)
    batch = min(8, val_images)

    log("[4/6] pre-tune mAP (exact serving program) ...")
    with leg("eval_pre"):
        pre = eval_detector.evaluate(model_name, init_ckpt, images, vboxes, vclasses,
                                     batch=batch, device=str(dev))
    log(f"  pre: {pre}")

    log(f"[5/6] fine-tuning {steps} steps ...")
    tuned_ckpt = os.path.join(workdir, f"{model_name}_tuned.msgpack")
    train_info = finetune(
        model_name, archive_root, labels, init_ckpt=init_ckpt, steps=steps,
        batch_size=batch_size, max_boxes=max_boxes, learning_rate=learning_rate,
        out_ckpt=tuned_ckpt, augment=augment, log=log, device=str(dev))
    with leg("eval_post"):
        post = eval_detector.evaluate(model_name, tuned_ckpt, images, vboxes, vclasses,
                                      batch=batch, device=str(dev))
    log(f"  post: {post}")

    # The served operating point, calibrated on the held-out set and
    # stamped into the checkpoint's metadata: the engine reads and applies
    # it per checkpoint at warmup.
    log("[5b/6] calibrating serving threshold on held-out data ...")
    with leg("calibrate"):
        cal = eval_detector.calibrate(model_name, tuned_ckpt, images, vboxes, vclasses,
                                      batch=batch, device=str(dev))
    set_msgpack_meta(tuned_ckpt, {
        "conf_threshold": cal["conf_threshold"],
        "calibration_policy": cal["policy"],
        "calibration_images": int(val_images),
    })
    log(f"  operating point: thr={cal['conf_threshold']} P={cal['precision']} "
        f"R={cal['recall']} F1={cal['f1']}")

    record = {
        "model": model_name,
        "chip": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": dev.type,
        "train_frames": n_train,
        "archived_segments": n_cameras * segments_per_camera,
        "source_hw": list(source_hw),
        "steps": train_info["steps"],
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "first_loss": train_info["first_loss"],
        "last_loss": train_info["last_loss"],
        "train_s": train_info["train_s"],
        "step_ms_p50": train_info["step_ms_p50"],
        "peak_reserved_bytes": train_info["peak_reserved_bytes"],
        "val_images": int(val_images),
        "pre": {k: pre[k] for k in ("mAP", "mAP50", "mAP75")},
        "post": {k: post[k] for k in ("mAP", "mAP50", "mAP75")},
        "calibration": {k: cal[k] for k in (
            "conf_threshold", "precision", "recall", "f1", "policy", "floor_precision")},
        "eval_batches": {"pre": pre["batches"], "post": post["batches"],
                         "calibrate": cal["batches"]},
        "checkpoint": tuned_ckpt,
    }

    if engine_leg:
        log("[6/6] engine serve-back (bus -> engine -> subscriber) ...")
        with leg("engine_pre"):
            record["engine_pre"] = engine_serve_metrics(model_name, init_ckpt, images, vboxes,
                                                        vclasses, device=str(dev))
        # The tuned checkpoint carries the calibrated threshold; the engine
        # applies it, so the scorer counts exactly what the engine emits.
        with leg("engine_post"):
            record["engine_post"] = engine_serve_metrics(model_name, tuned_ckpt, images,
                                                         vboxes, vclasses, conf=0.0,
                                                         device=str(dev))
        log(f"  engine pre:  {record['engine_pre']}")
        log(f"  engine post: {record['engine_post']}")

    record["wall_s"] = round(time.monotonic() - t_start, 2)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model", default="yolov8n")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--cameras", type=int, default=2)
    ap.add_argument("--segments", type=int, default=6, help="archived segments per camera")
    ap.add_argument("--frames", type=int, default=24, help="frames per segment")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--val-images", type=int, default=32)
    ap.add_argument("--augment", action="store_true")
    ap.add_argument("--easy", action="store_true",
                    help="easy synthetic site (big solid objects, low noise), the CPU "
                         "twin's setting")
    ap.add_argument("--no-engine-leg", action="store_true")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--record", default="", help="write the JSON record here")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    record = run(
        args.model, steps=args.steps, batch_size=args.batch, n_cameras=args.cameras,
        segments_per_camera=args.segments, frames_per_segment=args.frames,
        learning_rate=args.lr, val_images=args.val_images, augment=args.augment,
        obj_frac=(0.3, 0.5) if args.easy else (0.125, 0.334),
        noise=4.0 if args.easy else 8.0, workdir=args.workdir, seed=args.seed,
        engine_leg=not args.no_engine_leg, device=args.device)
    print(json.dumps(record))
    if args.record:
        with open(args.record, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
    return 0 if record["post"]["mAP50"] > record["pre"]["mAP50"] else 1


if __name__ == "__main__":
    sys.exit(main())

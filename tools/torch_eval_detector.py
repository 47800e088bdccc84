"""Detector accuracy through the port: COCO-style mAP of a (possibly
imported) checkpoint, and the serving threshold's calibration (the port's
counterpart of ``tools/eval_detector.py``, same layout and flags).

Usage:
    python tools/torch_eval_detector.py --model yolov8n \\
        --checkpoint /var/lib/vep/yolov8n.msgpack --data val.npz

``val.npz``: ``images`` [N, H, W, 3] uint8 BGR (any H/W: the serving
letterbox handles geometry as live frames get it), ``boxes`` [N, M, 4]
float32 xyxy image pixels padded with -1, ``classes`` [N, M] int64 padded
with -1.

Runs the port's exact serving program (``engine/runner.py``
``build_serving_step``: letterbox -> forward -> DFL decode -> NMS, the
keep-mask kernel on the card -> unletterbox) on ``--device`` (``cuda``
unless ``cpu`` is asked for), so the number printed is the accuracy of
what the engine serves. Scoring is ``models/metrics.py``
``DetectionEvaluator``, the port of the JAX package's evaluator.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_serving_step(model_name: str, checkpoint: str, device: str = "cuda"):
    """(serving step, model) with the engine's load path (``from_flax`` ->
    ``fit_state``, strict): one implementation shared by ``evaluate`` and
    ``calibrate``, so the threshold is always picked from identically
    loaded weights."""
    from video_edge_ai_proxy_tpu_torch.engine.runner import build_serving_step
    from video_edge_ai_proxy_tpu_torch.models import registry
    from video_edge_ai_proxy_tpu_torch.models.carry import fit_state, from_flax
    from video_edge_ai_proxy_tpu_torch.utils.checkpoint import load_msgpack

    spec = registry.get(model_name)
    if spec.kind != "detect":
        raise ValueError(f"{model_name!r} is {spec.kind!r}, not a detector")
    model = spec.init_params(device=device)
    if checkpoint:
        state = fit_state(from_flax(load_msgpack(checkpoint)), model)
        model.load_state_dict(state, strict=True)
    return build_serving_step(model, spec), model


def _batched_outputs(step, model, images: np.ndarray, batch: int, counter=None):
    """Yield (image index, boxes, scores, classes, valid) per image, one
    bucket with the tail padded with black frames. ``counter`` (a list)
    gets one entry a step call."""
    import torch

    dev = next(model.parameters()).device
    n = len(images)
    for lo in range(0, n, batch):
        chunk = images[lo:lo + batch]
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        out = step(torch.from_numpy(np.ascontiguousarray(chunk)).to(dev))
        if counter is not None:
            counter.append(len(chunk))
        pb = out["boxes"].float().cpu().numpy()
        ps = out["scores"].float().cpu().numpy()
        pc = out["classes"].cpu().numpy().astype(np.int64)
        pv = out["valid"].cpu().numpy().astype(bool)
        for bi in range(len(chunk) - pad):
            yield lo + bi, pb[bi], ps[bi], pc[bi], pv[bi]


def evaluate(model_name: str, checkpoint: str, images: np.ndarray, boxes: np.ndarray,
             classes: np.ndarray, score_thresh: float = 0.05, batch: int = 8,
             device: str = "cuda") -> dict:
    """-> {"mAP", "mAP50", "mAP75", "images": N, "batches": serving step
    calls}."""
    from video_edge_ai_proxy_tpu_torch.models.metrics import DetectionEvaluator

    step, model = _load_serving_step(model_name, checkpoint, device)
    ev = DetectionEvaluator()
    calls: list = []
    for i, pb, ps, pc, pv in _batched_outputs(step, model, images, batch, calls):
        keep = pv & (ps >= score_thresh)
        gt_keep = classes[i] >= 0
        ev.add_image(pb[keep], ps[keep], pc[keep], boxes[i][gt_keep], classes[i][gt_keep])
    result = ev.summarize()
    result["images"] = int(len(images))
    result["batches"] = len(calls)
    return result


def _iou_mat(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    da = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    ga = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = da[:, None] + ga[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def calibrate(model_name: str, checkpoint: str, images: np.ndarray, boxes: np.ndarray,
              classes: np.ndarray, *, batch: int = 8, iou_thr: float = 0.5,
              floor_precision: float = 0.5, grid=None, device: str = "cuda") -> dict:
    """Sweep the serving confidence threshold on held-out data and pick the
    operating point: max F1 among thresholds whose precision clears
    ``floor_precision``; if none do, the max-precision point. The value
    goes into checkpoint metadata (``conf_threshold``) and the engine
    applies it per checkpoint.

    Runs the serving program once, then scores every grid point from the
    same detections (greedy class-aware IoU matching at ``iou_thr``, score
    descending). ``batches`` in the result counts the step calls."""
    if grid is None:
        # The compiled NMS floor is 0.25: below it nothing survives to
        # filter, so the sweep starts there.
        grid = np.round(np.arange(0.25, 0.96, 0.025), 4)
    step, model = _load_serving_step(model_name, checkpoint, device)
    calls: list = []
    per_image = []      # (scores sorted desc, boxes, classes) per image
    for _i, pb_, ps, pc, pv in _batched_outputs(step, model, images, batch, calls):
        order = np.argsort(-ps[pv])
        per_image.append((ps[pv][order], pb_[pv][order], pc[pv][order]))

    sweep = []
    for thr in grid:
        tp = fp = n_gt = 0
        for i, (ds, db, dc) in enumerate(per_image):
            gt_keep = classes[i] >= 0
            gts, gcs = boxes[i][gt_keep], classes[i][gt_keep]
            n_gt += len(gts)
            sel = ds >= thr
            if not sel.any():
                continue
            sb, sc = db[sel], dc[sel]
            if len(gts) == 0:
                fp += len(sb)
                continue
            iou = _iou_mat(sb, gts.astype(np.float32))
            matched = np.zeros(len(gts), bool)
            for di in range(len(sb)):
                cand = np.where(~matched & (gcs == sc[di]) & (iou[di] >= iou_thr))[0]
                if len(cand):
                    matched[cand[np.argmax(iou[di][cand])]] = True
                    tp += 1
                else:
                    fp += 1
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / n_gt if n_gt else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        sweep.append({"thr": float(thr), "precision": round(p, 4), "recall": round(r, 4),
                      "f1": round(f1, 4)})

    ok = [s for s in sweep if s["precision"] >= floor_precision]
    best = (max(ok, key=lambda s: s["f1"]) if ok
            else max(sweep, key=lambda s: s["precision"]))
    return {
        "conf_threshold": best["thr"],
        "precision": best["precision"],
        "recall": best["recall"],
        "f1": best["f1"],
        "floor_precision": floor_precision,
        "policy": "max_f1_with_precision_floor" if ok else "max_precision",
        "sweep": sweep,
        "batches": len(calls),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--checkpoint", default="",
                    help="msgpack from tools/torch_import_weights.py (empty = random init, "
                         "useful only as a floor)")
    ap.add_argument("--data", required=True, help="val.npz (see module doc)")
    ap.add_argument("--score-thresh", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with np.load(args.data) as z:
        images, boxes, classes = z["images"], z["boxes"], z["classes"]
    result = evaluate(args.model, args.checkpoint, images, boxes, classes,
                      args.score_thresh, args.batch, device=args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Detection evaluation: COCO-style mean average precision (counterpart of
``video_edge_ai_proxy_tpu/models/metrics.py``, numpy on the host).

Host-side numpy (evaluation aggregates across a dataset; nothing here is
in the serving or training hot path). Greedy score-ordered matching per
(image, class) at IoU thresholds 0.50:0.95:0.05, 101-point interpolated AP
— the standard protocol. The accuracy gates of the serving variants score
a variant's detections against the fp step's as ground truth (mAP50).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] xyxy -> [N, M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


class DetectionEvaluator:
    """Accumulate per-image predictions + ground truth, then summarize."""

    def __init__(self):
        # per class: list of (score, match_flags[num_thresholds]) and GT count
        self._preds: Dict[int, List] = {}
        self._gt_count: Dict[int, int] = {}

    def add_image(
        self,
        pred_boxes: np.ndarray, pred_scores: np.ndarray, pred_classes: np.ndarray,
        gt_boxes: np.ndarray, gt_classes: np.ndarray,
    ) -> None:
        pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
        pred_scores = np.asarray(pred_scores, np.float32).reshape(-1)
        pred_classes = np.asarray(pred_classes, np.int64).reshape(-1)
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)

        for cls in np.unique(np.concatenate([pred_classes, gt_classes])):
            p_sel = pred_classes == cls
            g_sel = gt_classes == cls
            self._gt_count[cls] = self._gt_count.get(cls, 0) + int(g_sel.sum())
            if not p_sel.any():
                continue
            boxes, scores = pred_boxes[p_sel], pred_scores[p_sel]
            order = np.argsort(-scores)
            boxes, scores = boxes[order], scores[order]
            iou = _iou_matrix(boxes, gt_boxes[g_sel])
            matches = np.zeros((len(boxes), len(IOU_THRESHOLDS)), bool)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                taken = np.zeros(iou.shape[1], bool)
                for pi in range(len(boxes)):
                    if iou.shape[1] == 0:
                        break
                    cand = np.where(~taken & (iou[pi] >= thr))[0]
                    if len(cand):
                        best = cand[np.argmax(iou[pi][cand])]
                        taken[best] = True
                        matches[pi, ti] = True
            bucket = self._preds.setdefault(int(cls), [])
            for s, m in zip(scores, matches):
                bucket.append((float(s), m))

    @staticmethod
    def _ap(scores: np.ndarray, matched: np.ndarray, n_gt: int) -> float:
        """101-point interpolated AP for one (class, threshold)."""
        if n_gt == 0:
            return float("nan")
        if len(scores) == 0:
            return 0.0
        order = np.argsort(-scores)
        tp = matched[order].astype(np.float64)
        fp = 1.0 - tp
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        # precision envelope + 101-point sampling (COCO)
        precision = np.maximum.accumulate(precision[::-1])[::-1]
        recall_points = np.linspace(0, 1, 101)
        idx = np.searchsorted(recall, recall_points, side="left")
        sampled = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
        return float(sampled.mean())

    def summarize(self) -> Dict[str, float]:
        """-> {"mAP": AP@[.5:.95], "mAP50": AP@.5, "mAP75": AP@.75}."""
        per_thr: List[List[float]] = [[] for _ in IOU_THRESHOLDS]
        for cls, n_gt in self._gt_count.items():
            entries = self._preds.get(cls, [])
            if n_gt == 0:
                continue
            scores = np.asarray([s for s, _ in entries], np.float32)
            match_mat = (
                np.stack([m for _, m in entries])
                if entries else np.zeros((0, len(IOU_THRESHOLDS)), bool)
            )
            for ti in range(len(IOU_THRESHOLDS)):
                per_thr[ti].append(
                    self._ap(scores, match_mat[:, ti], n_gt)
                )
        if not any(per_thr):
            return {"mAP": 0.0, "mAP50": 0.0, "mAP75": 0.0}
        ap_per_thr = np.asarray([np.mean(v) if v else 0.0 for v in per_thr])
        return {
            "mAP": float(ap_per_thr.mean()),
            "mAP50": float(ap_per_thr[0]),
            "mAP75": float(ap_per_thr[5]),
        }

"""Per-stream multi-object tracking (counterpart of
``video_edge_ai_proxy_tpu/engine/tracker.py``).

A SORT-style tracker (greedy IoU association plus constant-velocity
extrapolation, no Kalman filter) runs on the host per stream on the
already-fetched NMS output and fills ``Detection.track_id``. Detections
and live tracks are matched greedily by IoU (same class only, predicted
track box against detection box); unmatched detections open new tracks at
once; unmatched tracks coast on their velocity and are dropped after
``max_misses`` consecutive misses. Ids are a stream-scoped monotonic int,
rendered as strings.

The tracks live in arrays rather than one object each, and the greedy
match walks the candidate pairs once in (IoU descending, row-major index)
order instead of taking the matrix's argmax again after every match, and
the matched tracks update in one array operation: the same pairs in the
same order, so the ids, boxes and velocities equal the JAX tracker's
exactly (``tests/test_torch_engine_pipeline.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] xyxy -> [N,M] IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.maximum(br - tl, 0.0), axis=-1)
    area_a = np.prod(np.maximum(a[:, 2:] - a[:, :2], 0.0), axis=-1)
    area_b = np.prod(np.maximum(b[:, 2:] - b[:, :2], 0.0), axis=-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def _empty_i64() -> np.ndarray:
    return np.zeros(0, np.int64)


def _empty_box() -> np.ndarray:
    return np.zeros((0, 4), np.float32)


@dataclass
class IoUTracker:
    """One tracker per stream (the engine keeps a dict keyed by device_id)."""

    iou_thresh: float = 0.3
    max_misses: int = 30       # frames a lost track coasts before dropping
    # A gap longer than this between updates (a stream outage) clears all
    # tracks, so an old id is never handed to whatever appears near a
    # stale box on reconnect; ids keep counting up.
    max_gap_s: float = 10.0
    # First id this tracker issues: a replacement tracker (model switch)
    # starts at its predecessor's next_id, so ids stay unique per stream.
    next_id: int = 1
    # Live tracks, one row each, in creation order.
    _ids: np.ndarray = field(default_factory=_empty_i64)
    _box: np.ndarray = field(default_factory=_empty_box)   # xyxy f32
    _vel: np.ndarray = field(default_factory=_empty_box)   # d(box)/frame f32
    _cls: np.ndarray = field(default_factory=_empty_i64)
    _miss: np.ndarray = field(default_factory=_empty_i64)
    _conf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    _last_update: float = 0.0

    def update(self, boxes: Sequence[Sequence[float]], classes: Sequence[int],
               now: Optional[float] = None,
               scores: Optional[Sequence[float]] = None) -> List[str]:
        """One frame of detections -> one track id per detection, in order.
        ``scores`` (parallel to ``boxes``) stores each matched detection's
        confidence on its track; omitted, confidences keep their value
        (new tracks start at 0)."""
        now = time.monotonic() if now is None else now
        if self._last_update and now - self._last_update > self.max_gap_s:
            self._keep(np.zeros(len(self._ids), bool))
        self._last_update = now
        dets = np.asarray(boxes, np.float32).reshape(-1, 4)
        cls = np.asarray(classes, np.int64).reshape(-1)

        # Predict: coast every live track along its velocity.
        self._box = self._box + self._vel
        iou = _iou_matrix(self._box, dets)
        iou[self._cls[:, None] != cls[None, :]] = 0.0   # same-class gating

        # Greedy: the globally best remaining pair first, ties to the
        # lower row-major index (np.argmax's order).
        assigned = np.full(len(dets), -1, np.int64)
        matched = np.zeros(len(self._ids), bool)
        rows, cols = np.nonzero(iou >= self.iou_thresh)
        if len(rows):
            order = np.lexsort((rows * iou.shape[1] + cols, -iou[rows, cols]))
            pairs_r: List[int] = []
            pairs_c: List[int] = []
            for r, c in zip(rows[order].tolist(), cols[order].tolist()):
                if matched[r] or assigned[c] != -1:
                    continue
                matched[r] = True
                assigned[c] = self._ids[r]
                pairs_r.append(r)
                pairs_c.append(c)
            # Each track and detection is in at most one pair, so the
            # updates apply at once. box is the prediction, so (det - box)
            # is the residual; adding half of it is an EMA (alpha 0.5) of
            # the per-frame deltas.
            self._vel[pairs_r] = self._vel[pairs_r] + 0.5 * (dets[pairs_c] - self._box[pairs_r])
            self._box[pairs_r] = dets[pairs_c]
            self._miss[pairs_r] = 0
            if scores is not None:
                self._conf[pairs_r] = np.asarray(scores, np.float64).reshape(-1)[pairs_c]

        # Unmatched tracks count a miss; the stale ones drop.
        self._miss[~matched] += 1
        self._keep(matched | (self._miss <= self.max_misses))

        # Unmatched detections open new tracks, ids issued at once.
        new = np.nonzero(assigned == -1)[0]
        if len(new):
            ids = np.arange(self.next_id, self.next_id + len(new), dtype=np.int64)
            self.next_id += len(new)
            assigned[new] = ids
            self._ids = np.concatenate([self._ids, ids])
            self._box = np.concatenate([self._box, dets[new]])
            self._vel = np.concatenate([self._vel, np.zeros((len(new), 4), np.float32)])
            self._cls = np.concatenate([self._cls, cls[new]])
            self._miss = np.concatenate([self._miss, np.zeros(len(new), np.int64)])
            conf = (np.asarray(scores, np.float64).reshape(-1)[new] if scores is not None
                    else np.zeros(len(new), np.float64))
            self._conf = np.concatenate([self._conf, conf])
        return [str(a) for a in assigned.tolist()]

    def _keep(self, rows: np.ndarray) -> None:
        self._ids, self._box, self._vel = self._ids[rows], self._box[rows], self._vel[rows]
        self._cls, self._miss, self._conf = self._cls[rows], self._miss[rows], self._conf[rows]

    @property
    def live_tracks(self) -> int:
        return len(self._ids)

    def tracks(self) -> List[dict]:
        """Snapshot of live tracks at their current (predicted) boxes, as
        plain floats and ints."""
        return [
            {"track_id": int(i), "box": tuple(float(v) for v in b), "class_id": int(c),
             "misses": int(m), "confidence": float(f)}
            for i, b, c, m, f in zip(self._ids, self._box, self._cls, self._miss, self._conf)
        ]

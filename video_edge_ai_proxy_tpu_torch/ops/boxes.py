"""Box utilities (counterpart of ``video_edge_ai_proxy_tpu/ops/boxes.py``).

The IoU formula and its order of operations are those of the JAX package,
so that the NMS keep mask built on it agrees bit for bit. ``uncrop_boxes``
is host numpy: the ROI path's scatter-back runs after the read-back.
"""

from __future__ import annotations

import numpy as np
import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> [...] area (clamped at 0 for degenerate boxes)."""
    w = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0)
    h = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: [..., N, 4], b: [..., M, 4] xyxy -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def dist_to_bbox(distances: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """Anchor-free head decode: [..., A, 4] (l, t, r, b) distances and
    [A, 2] (x, y) anchor points in pixels -> [..., A, 4] xyxy."""
    x1y1 = anchor_points - distances[..., :2]
    x2y2 = anchor_points + distances[..., 2:]
    return torch.cat([x1y1, x2y2], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    half_w, half_h = w * 0.5, h * 0.5
    return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def uncrop_boxes(boxes_xyxy, *, scale: float, dst_origin: tuple, src_origin: tuple):
    """Boxes in packed-canvas pixels -> source-frame pixels: the exact
    inverse of one crop's placement on a canvas (``engine/collector.py``
    ``CanvasPacker``). A crop taken at ``src_origin`` (x0, y0), decimated
    by the integer ``scale`` (source px per canvas px) and blitted at
    ``dst_origin`` maps back as

        src = (canvas - dst_origin) * scale + src_origin

    Host-side float32 numpy after NMS (the engine's scatter-back), [..., 4]
    xyxy in, the same shape out."""
    shift = np.asarray([dst_origin[0], dst_origin[1]] * 2, np.float32)
    offset = np.asarray([src_origin[0], src_origin[1]] * 2, np.float32)
    return (np.asarray(boxes_xyxy, np.float32) - shift) * np.float32(scale) + offset

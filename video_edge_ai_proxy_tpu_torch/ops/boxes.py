"""Box utilities on tensors (counterpart of ``video_edge_ai_proxy_tpu/ops/boxes.py``).

The IoU formula and its order of operations are those of the JAX package,
so that the NMS keep mask built on it agrees bit for bit.
"""

from __future__ import annotations

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

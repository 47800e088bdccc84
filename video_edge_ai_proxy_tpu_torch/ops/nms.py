"""Greedy NMS with static shapes (counterpart of ``video_edge_ai_proxy_tpu/ops/nms.py``).

The keep mask over K score-sorted boxes is

    keep = 1^K
    for i in 0..K-1:
        keep &= ~(keep[i] & iou[i, :] > t & j > i)

which is exactly greedy NMS. Two implementations with identical outputs:

- the CUDA kernel ``kernels/nms.py`` ``nms_keep_mask_cuda`` (the port of
  the Pallas ``_nms_kernel``), for tensors on the card;
- ``nms_keep_mask_reference``, the plain PyTorch loop (the twin of the
  JAX package's ``nms_keep_mask_xla``), for tensors on the CPU and as the
  kernel's yardstick on the card.

``nms_keep_mask`` picks between them by the tensor's device only.
``batched_nms`` is the user-facing op: score filter -> top-k candidates ->
class-offset trick -> keep mask -> top max_det, over the whole batch at
once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .boxes import box_iou_matrix

# Class-aware NMS via the coordinate-offset trick: boxes of different
# classes are translated far apart so they can never overlap.
_CLASS_OFFSET = 8192.0


def nms_keep_mask_reference(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """[..., K, 4] xyxy boxes sorted by score desc -> [..., K] bool keep
    mask, by the plain row-at-a-time loop."""
    boxes = boxes.to(torch.float32)
    k = boxes.shape[-2]
    iou = box_iou_matrix(boxes, boxes)
    idx = torch.arange(k, device=boxes.device)
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    for i in range(k):
        suppress = keep[..., i:i + 1] & (iou[..., i, :] > iou_thresh) & (idx > i)
        keep = keep & ~suppress
    return keep


def nms_keep_mask(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """[B, K, 4] sorted-desc boxes -> [B, K] bool keep mask: the CUDA
    kernel for a tensor on the card, the plain loop for one on the CPU."""
    if boxes.device.type == "cuda":
        from ..kernels.nms import nms_keep_mask_cuda

        return nms_keep_mask_cuda(boxes, iou_thresh)
    if boxes.device.type == "cpu":
        return nms_keep_mask_reference(boxes, iou_thresh)
    raise ValueError(f"nms_keep_mask: unsupported device {boxes.device}")


def _top(values: torch.Tensor, n: int):
    """Top ``n`` along the last axis, ties toward the lower index (the
    order of ``lax.top_k``; bare ``torch.topk`` leaves it unspecified)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: Optional[torch.Tensor] = None,
    *,
    iou_thresh: float = 0.45,
    score_thresh: float = 0.25,
    max_candidates: int = 256,
    max_det: int = 100,
    keep_mask: Callable[[torch.Tensor, float], torch.Tensor] = nms_keep_mask,
):
    """Class-aware batched NMS with static shapes.

    boxes: [B, A, 4] xyxy; scores: [B, A]; classes: [B, A] int (or None for
    class-agnostic). Returns (boxes [B, max_det, 4] f32, scores [B, max_det]
    f32, classes [B, max_det] int32, valid [B, max_det] bool); invalid slots
    are zeroed. ``keep_mask`` computes the keep mask of the sorted,
    class-offset candidates (default: the device's own, ``nms_keep_mask``).
    """
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    if classes is None:
        classes = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    classes = classes.to(torch.int32)
    num_anchors = scores.shape[-1]
    n_cand = min(max_candidates, num_anchors)
    n_det = min(max_det, n_cand)

    scores = torch.where(scores >= score_thresh, scores, 0.0)
    top_scores, top_idx = _top(scores, n_cand)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, top_idx)
    shifted = top_boxes + top_classes[..., None].to(torch.float32) * _CLASS_OFFSET
    # Zero-score (filtered) slots become degenerate boxes at the class-0
    # origin: IoU 0 with everything, then re-filtered by `valid` below.
    shifted = torch.where(top_scores[..., None] > 0.0, shifted, 0.0)
    keep = keep_mask(shifted, iou_thresh)
    kept_scores = torch.where(keep, top_scores, 0.0)
    out_scores, out_idx = _top(kept_scores, n_det)
    valid = out_scores > 0.0
    out_boxes = torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(valid[..., None], out_boxes, 0.0)
    out_classes = torch.where(valid, torch.gather(top_classes, 1, out_idx), 0)
    pad = max_det - n_det  # keep the public output shape stable
    if pad:
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return out_boxes, out_scores, out_classes.to(torch.int32), valid

"""YOLOv8 detection loss (counterpart of ``video_edge_ai_proxy_tpu/models/detect_loss.py``):
task-aligned assignment + CIoU + DFL.

Everything is static-shape: ground truth arrives padded to ``max_boxes``
with a validity mask, and the assignment is a dense [B, M, A] tensor
computation, as in the JAX package. Components (standard YOLOv8):

- Task-aligned assigner: align = cls_prob^alpha * IoU^beta over anchors
  whose centre lies inside the GT box; top-k per GT; conflicts resolved to
  the highest-align GT (the first on ties).
- Classification: BCE against IoU-scaled soft targets.
- Box: CIoU loss on assigned anchors.
- DFL: two-hot cross-entropy on the ltrb bin distribution.

The port's head levels are NCHW; ``flatten_levels`` permutes them to NHWC
before flattening, so anchors come out in the JAX order (row-major h*w per
level, levels in stride order) and the assigner pairs the same anchors.
``maximum``/``minimum`` stand where JAX has ``jnp.maximum``/``jnp.clip``:
their gradient splits evenly at ties, as JAX's does (``clamp``'s would
not).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import batch_statistics
from .yolov8 import YOLOv8Config, _anchor_points

ALPHA, BETA = 0.5, 6.0          # TAL exponents
TOP_K = 10
W_BOX, W_CLS, W_DFL = 7.5, 0.5, 1.5
EPS = 1e-9


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(v))


def flatten_levels(head_out, cfg: YOLOv8Config):
    """Per-level NCHW head outputs -> flat ``(box_logits [B, A, 4*reg_max],
    cls_logits [B, A, C], anchors [A, 2] px, strides [A])``."""
    box_l, cls_l, anchors, strides = [], [], [], []
    for (box, cls), stride in zip(head_out, cfg.strides):
        b, _, h, w = box.shape
        box_l.append(box.permute(0, 2, 3, 1).reshape(b, h * w, 4 * cfg.reg_max))
        cls_l.append(cls.permute(0, 2, 3, 1).reshape(b, h * w, cfg.num_classes))
        anchors.append(_anchor_points(h, w, stride, box.device))
        strides.append(torch.full((h * w,), float(stride), device=box.device))
    return (torch.cat(box_l, 1), torch.cat(cls_l, 1), torch.cat(anchors, 0),
            torch.cat(strides, 0))


def _decode_dfl(box_logits: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor,
                reg_max: int) -> torch.Tensor:
    """[B, A, 4*reg_max] -> xyxy px (the inference decode's math)."""
    b, a, _ = box_logits.shape
    probs = torch.softmax(box_logits.reshape(b, a, 4, reg_max).float(), dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=box_logits.device)
    dist = torch.matmul(probs, bins) * strides[None, :, None]
    return torch.cat([anchors[None] - dist[..., :2], anchors[None] + dist[..., 2:]], -1)


def iou_pairwise(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """[B, M, 4] x [B, A, 4] -> IoU [B, M, A]."""
    gt_ = gt[:, :, None, :]
    pr_ = pred[:, None, :, :]
    lt = torch.maximum(gt_[..., :2], pr_[..., :2])
    rb = torch.minimum(gt_[..., 2:], pr_[..., 2:])
    wh = _max(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_g = _max(gt_[..., 2] - gt_[..., 0], 0.0) * _max(gt_[..., 3] - gt_[..., 1], 0.0)
    area_p = _max(pr_[..., 2] - pr_[..., 0], 0.0) * _max(pr_[..., 3] - pr_[..., 1], 0.0)
    return inter / _max(area_g + area_p - inter, EPS)


def ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Complete IoU between aligned boxes [..., 4] xyxy -> [...]."""
    lt = torch.maximum(box1[..., :2], box2[..., :2])
    rb = torch.minimum(box1[..., 2:], box2[..., 2:])
    wh = _max(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    w1, h1 = box1[..., 2] - box1[..., 0], box1[..., 3] - box1[..., 1]
    w2, h2 = box2[..., 2] - box2[..., 0], box2[..., 3] - box2[..., 1]
    union = w1 * h1 + w2 * h2 - inter
    iou = inter / _max(union, EPS)
    # enclosing box diagonal
    elt = torch.minimum(box1[..., :2], box2[..., :2])
    erb = torch.maximum(box1[..., 2:], box2[..., 2:])
    ewh = _max(erb - elt, 0.0)
    c2 = ewh[..., 0] ** 2 + ewh[..., 1] ** 2
    # centre distance
    cx1, cy1 = (box1[..., 0] + box1[..., 2]) / 2, (box1[..., 1] + box1[..., 3]) / 2
    cx2, cy2 = (box2[..., 0] + box2[..., 2]) / 2, (box2[..., 1] + box2[..., 3]) / 2
    rho2 = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2
    # aspect-ratio consistency; alpha is a weight, not a gradient path (JAX
    # stop_gradient)
    v = (4 / math.pi ** 2) * (
        torch.atan(w2 / _max(h2, EPS)) - torch.atan(w1 / _max(h1, EPS))) ** 2
    alpha = (v / _max(1 - iou + v, EPS)).detach()
    return iou - rho2 / _max(c2, EPS) - alpha * v


@torch.no_grad()
def assign(cls_logits: torch.Tensor, pred_boxes: torch.Tensor, anchors: torch.Tensor,
           gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
           gt_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Task-aligned assignment (a target builder: no gradient). Inputs:
    cls_logits [B, A, C], pred_boxes [B, A, 4] px, anchors [A, 2], gt_boxes
    [B, M, 4] px xyxy, gt_labels [B, M] int, gt_mask [B, M] bool. Returns
    (fg [B, A] bool, gt_idx [B, A] int64, norm_align [B, A], the IoU-scaled
    soft target weight)."""
    b, a, c = cls_logits.shape
    m = gt_boxes.shape[1]
    ax = anchors[None, None, :, 0]
    ay = anchors[None, None, :, 1]
    in_gt = ((ax >= gt_boxes[..., 0:1]) & (ax < gt_boxes[..., 2:3])
             & (ay >= gt_boxes[..., 1:2]) & (ay < gt_boxes[..., 3:4]))      # [B, M, A]
    valid = in_gt & gt_mask[..., None].bool()

    probs = torch.sigmoid(cls_logits)                                      # [B, A, C]
    labels = gt_labels.long().clamp(0, c - 1)
    cls_score = torch.gather(probs.transpose(1, 2), 1,
                             labels[..., None].expand(b, m, a))            # [B, M, A]
    ious = iou_pairwise(gt_boxes, pred_boxes)                              # [B, M, A]
    align = (cls_score ** ALPHA) * (_max(ious, 0.0) ** BETA)
    align = torch.where(valid, align, torch.zeros_like(align))

    # Top-k per GT, with the k-th value itself as the floor, RELATIVE,
    # never an absolute epsilon: at random init align can sit at 1e-10 for
    # small objects, and an absolute cut rejected every real candidate (no
    # positives, the class head collapsed to -inf in the JAX package's
    # first self-train runs). With kth == 0 every align > 0 anchor is
    # admitted.
    k = min(TOP_K, a)
    kth = torch.sort(align, dim=-1).values[..., -k][..., None]             # [B, M, 1]
    topk = (align >= kth) & (align > 0)

    # conflicts: an anchor goes to the GT of max align (the first on ties)
    align_masked = torch.where(topk, align, torch.zeros_like(align))
    best = align_masked.amax(dim=1)                                        # [B, A]
    gt_idx = torch.argmax(align_masked, dim=1)
    fg = best > 0

    # normalise: per-GT max align -> per-GT max IoU (YOLOv8 target scaling)
    pos_iou = torch.where(topk, ious, torch.zeros_like(ious))
    gt_max_align = align_masked.amax(dim=-1)                               # [B, M]
    gt_max_iou = pos_iou.amax(dim=-1)
    scale = gt_max_iou / _max(gt_max_align, EPS)
    norm_align = best * torch.gather(scale, 1, gt_idx)
    return fg, gt_idx, torch.where(fg, norm_align, torch.zeros_like(norm_align))


def optax_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE, as the JAX package writes it."""
    return _max(logits, 0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def detection_loss(head_out, targets: Dict[str, torch.Tensor], cfg: YOLOv8Config) -> torch.Tensor:
    """Total loss for the raw head output (``model(x, decode=False)``).

    targets: {"boxes": [B, M, 4] px xyxy, "labels": [B, M] int,
              "mask": [B, M] bool}.
    """
    box_logits, cls_logits, anchors, strides = flatten_levels(head_out, cfg)
    box_logits, cls_logits = box_logits.float(), cls_logits.float()
    pred_boxes = _decode_dfl(box_logits, anchors, strides, cfg.reg_max)
    # The assigner builds targets (ultralytics runs it under no_grad), and
    # detaching matters numerically: align spans ~1e-40..1, and gradients
    # through a / max(b, EPS) overflow to inf for tiny aligns (NaN steps in
    # the JAX package's first self-train runs).
    gt_boxes = targets["boxes"].float()
    gt_labels = targets["labels"].long()
    fg, gt_idx, weight = assign(cls_logits.detach(), pred_boxes.detach(), anchors, gt_boxes,
                                gt_labels, targets["mask"])
    b, a, c = cls_logits.shape
    t_boxes = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(b, a, 4))   # [B, A, 4]
    t_labels = torch.gather(gt_labels, 1, gt_idx)
    # one_hot as jax.nn.one_hot: an out-of-range label gives a zero row
    one_hot = (t_labels[..., None] == torch.arange(c, device=t_labels.device)).float()
    t_scores = one_hot * weight[..., None]

    cls_loss = optax_bce(cls_logits, t_scores).sum() / _max(t_scores.sum(), 1.0)

    zero = torch.zeros((), device=cls_logits.device)
    iou_term = (1.0 - ciou(pred_boxes, t_boxes)) * weight
    denom = _max(weight.sum(), 1.0)
    box_loss = torch.where(fg, iou_term, zero).sum() / denom

    # DFL: two-hot cross entropy on ltrb distances in stride units
    lt = (anchors[None] - t_boxes[..., :2]) / strides[None, :, None]
    rb = (t_boxes[..., 2:] - anchors[None]) / strides[None, :, None]
    dist = torch.cat([lt, rb], -1)
    dist = torch.minimum(_max(dist, 0.0), dist.new_tensor(cfg.reg_max - 1 - 0.01))
    lo = torch.floor(dist)
    hi_w = dist - lo
    logp = F.log_softmax(box_logits.reshape(b, a, 4, cfg.reg_max), dim=-1)
    lo_i = lo.long()
    lp_lo = torch.gather(logp, -1, lo_i[..., None])[..., 0]
    lp_hi = torch.gather(logp, -1, (lo_i + 1).clamp(0, cfg.reg_max - 1)[..., None])[..., 0]
    dfl = -((1 - hi_w) * lp_lo + hi_w * lp_hi).mean(-1) * weight
    dfl_loss = torch.where(fg, dfl, zero).sum() / denom

    return W_BOX * box_loss + W_CLS * cls_loss + W_DFL * dfl_loss


def make_detection_loss_fn(cfg: YOLOv8Config, update_stats: bool = False):
    """The port trainer's ``loss_fn(model, batch, targets)`` with targets
    the padded dict above; ``batch`` is the model's NCHW input.

    ``update_stats=False`` (default): BatchNorm runs on frozen statistics,
    the near-distribution fine-tune stance for imported checkpoints.
    ``update_stats=True``: BatchNorm normalises by batch statistics and
    updates its running ones (``common.batch_statistics``), for
    ``make_trainer(..., mutable_aux=True)``; REQUIRED from scratch, where
    frozen random-init statistics degenerate deep features into
    constants."""
    def loss_fn(model, batch, targets):
        with batch_statistics(model, update_stats):
            head_out = model(batch, decode=False)
        return detection_loss(head_out, targets, cfg)

    return loss_fn
